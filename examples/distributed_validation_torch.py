"""Distributed validation internals on PyTorch: sharded exact MIPS and
straggler-tolerant chunked corpus encoding.

The twin of ``examples/distributed_validation.py`` on the port
(``repro_torch``).  The original forces 8 host devices on XLA; here the
mesh is the port's single-controller :class:`DeviceMesh` over one device
repeated 8 times, shaped (4, 2) as ("data", "model"): each of the 8
shards is a block of corpus rows on that device, scored by its own
``topk_exact``, and the shards' candidates merge one mesh axis at a time,
innermost first.

    python examples/distributed_validation_torch.py               # on the GPU
    python examples/distributed_validation_torch.py --device cpu
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.retrieval import topk_exact, topk_sharded  # noqa: E402
from repro_torch.distributed import compat  # noqa: E402
from repro_torch.distributed.fault import run_chunked  # noqa: E402


def main(*, device: str = "cuda", Q: int = 16, N: int = 40_000, D: int = 64,
         k: int = 100, seed: int = 0) -> dict:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' (the default) but no CUDA device "
                           "is visible; pass --device cpu to run on the CPU")
    dev = torch.device(device)
    mesh = compat.make_mesh((4, 2), ("data", "model"), devices=[dev] * 8)
    rng = np.random.default_rng(seed)
    q_np = rng.normal(size=(Q, D)).astype(np.float32)
    c_np = rng.normal(size=(N, D)).astype(np.float32)
    q = torch.from_numpy(q_np).to(dev)
    c = torch.from_numpy(c_np).to(dev)

    # -- sharded exact MIPS: row-sharded corpus, hierarchical top-k merge --
    s_ref, i_ref = topk_exact(q, c, k=k)
    s_sh, i_sh = topk_sharded(mesh, q, c, k=k)
    i_ref, i_sh = i_ref.cpu().numpy(), i_sh.cpu().numpy()
    agree = float((i_sh == i_ref).mean())
    print(f"[distributed] sharded top-{k} over {N} rows x 8 shards: "
          f"index agreement with single-device = {agree:.4f}")
    assert agree > 0.99

    # -- straggler-tolerant chunked encode ---------------------------------
    # one worker is 10x slower; speculation hides it.
    def encode_chunk(idxs):
        return c_np[idxs].sum(axis=1)                 # stand-in for encode

    items = list(range(N))
    delays = {"w0": 0.02}                              # w0 is the straggler
    t0 = time.time()
    out = run_chunked(items, encode_chunk, n_workers=4, over_factor=4,
                      worker_delay=lambda w: delays.get(w, 0.0))
    dt = time.time() - t0
    total = sum(len(o) for o in out)
    print(f"[distributed] chunked encode of {total} items with a 1-in-4 "
          f"straggler + speculation: {dt:.2f}s, results exact = "
          f"{total == N}")
    assert total == N
    return {"agree": agree, "ids_sharded": i_sh, "ids_exact": i_ref,
            "scores_sharded": s_sh.cpu().numpy(),
            "scores_exact": s_ref.cpu().numpy(), "chunked_items": total,
            "chunked_s": dt}


def _cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    return main(device=args.device)


if __name__ == "__main__":
    _cli()
