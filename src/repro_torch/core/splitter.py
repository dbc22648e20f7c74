"""The paper's ``python -m asyncval.splitter`` CLI (§3).

    python -m repro_torch.core.splitter \\
        --candidate_dir corpus_dir --run_file bm25.trec \\
        --qrel_file qrels.txt --output_dir subset_dir --depth 100

Keeps the union over queries of the run's top-``depth`` passages plus all
gold passages, written as pre-tokenized JSONL ready for repro_torch.core.cli.
The output file is byte for byte the one ``python -m repro.core.splitter``
writes for the same inputs.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.core.splitter")
    ap.add_argument("--candidate_dir", required=True)
    ap.add_argument("--run_file", required=True)
    ap.add_argument("--qrel_file", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--depth", type=int, required=True)
    args = ap.parse_args(argv)

    from repro_torch.core.metrics import read_trec_qrels, read_trec_run
    from repro_torch.core.samplers import RunFileTopK, write_subset_jsonl
    from repro_torch.data.corpus import read_jsonl

    corpus = {}
    for p in sorted(glob.glob(os.path.join(args.candidate_dir, "*.json*"))):
        corpus.update(read_jsonl(p))
    run = read_trec_run(args.run_file)
    qrels = read_trec_qrels(args.qrel_file)

    subset = RunFileTopK(depth=args.depth).sample(list(corpus), run, qrels)
    os.makedirs(args.output_dir, exist_ok=True)
    out = os.path.join(args.output_dir, f"subset_top{args.depth}.jsonl")
    write_subset_jsonl(subset, corpus, out)
    print(f"[splitter] {len(corpus)} passages -> {subset.size} "
          f"(depth={args.depth}) -> {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
