"""A run with the timed path broken underneath comes out not correct.

Each cell runs at a small size on the CPU, past the entry point's look
for a chip, with one fault planted in the port: a step that returns its
state unchanged, half of the batch left out, an answer altered where it
is produced (and, for validation, a metric altered in the ledger).  A
sound run at the same size comes out correct.  The limits are the
cells' own."""

import pytest

from bench.tests.small import run_small

VALIDATE = ["dr-bert-base.validate-msmarco", "qwen2-0.5b-dr.validate-msmarco"]
SERVE = ["dr-bert-base.serve-msmarco"]


def _stale_params(keep):
    """A restore that returns the tree of its ``keep``-th call for every
    later step: 1 keeps the first checkpoint, 2 the second."""
    def plant(mp):
        from repro_torch.core.validator import ValidatorWorker
        orig = ValidatorWorker.load_params
        trees = []

        def load(self, step):
            if len(trees) < keep:
                trees.append(orig(self, step))
            return trees[-1]                # every later step: unchanged
        mp.setattr(ValidatorWorker, "load_params", load)
    plant.__name__ = f"_stale_params_{keep}"
    return plant


def _half_of_each_chunk(mp):
    from repro_torch.core.engine import CudaStreamTopKStage
    orig = CudaStreamTopKStage.step

    def step(self, params, q_emb, carry, toks, mask, base, n_valid):
        return orig(self, params, q_emb, carry, toks, mask, base,
                    n_valid // 2)
    mp.setattr(CudaStreamTopKStage, "step", step)


def _altered_answer(mp):
    from repro_torch.core.engine import StreamingEngine
    orig = StreamingEngine.run

    def run(self, params):
        run_, scores, timings = orig(self, params)
        qids = list(run_)
        other = [d for d in run_[qids[1]] if d not in run_[qids[0]]]
        run_[qids[0]] = [other[-1]] + run_[qids[0]][1:]
        return run_, scores, timings
    mp.setattr(StreamingEngine, "run", run)


def _altered_metric(mp):
    from repro_torch.core import metrics
    orig = metrics.compute_metrics

    def compute(run, qrels, names):
        out = orig(run, qrels, names)
        return {k: v + 1e-3 for k, v in out.items()}
    mp.setattr(metrics, "compute_metrics", compute)


def _stale_answers(mp):
    from repro_torch.serve.index import ServingIndex
    orig = ServingIndex.search
    last = {}

    def search(self, q_emb, *, k):
        out = orig(self, q_emb, k=k)
        prev = last.get("out", out)
        last["out"] = out
        return prev                         # the previous batch's answers
    mp.setattr(ServingIndex, "search", search)


def _half_of_each_batch(mp):
    from repro_torch.serve.service import QueryService
    orig = QueryService._score

    def score(self, index, token_rows):
        ids, scores = orig(self, index, token_rows)
        half = (len(ids) + 1) // 2
        return (ids[:half] + ids[:len(ids) - half],
                scores[:half] + scores[:len(ids) - half])
    mp.setattr(QueryService, "_score", score)


def _altered_served_answer(mp):
    from repro_torch.serve.index import ServingIndex
    orig = ServingIndex.search

    def search(self, q_emb, *, k):
        ids, scores = orig(self, q_emb, k=k)
        for row in ids:
            row[0] = str((int(row[0]) + 1) % self.n_docs)
        return ids, scores
    mp.setattr(ServingIndex, "search", search)


@pytest.mark.parametrize("cell", VALIDATE + SERVE)
def test_a_sound_small_run_is_correct(cell):
    res = run_small(cell, seed=11)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("seed", [12, 14])
@pytest.mark.parametrize("fault", [_stale_params(1), _stale_params(2),
                                   _half_of_each_chunk, _altered_answer,
                                   _altered_metric],
                         ids=lambda f: f.__name__.lstrip("_"))
@pytest.mark.parametrize("cell", VALIDATE)
def test_a_broken_validation_is_not_correct(cell, fault, seed, monkeypatch):
    fault(monkeypatch)
    res = run_small(cell, seed=seed)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [_stale_answers, _half_of_each_batch,
                                   _altered_served_answer])
@pytest.mark.parametrize("cell", SERVE)
def test_a_broken_service_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run_small(cell, seed=13)
    assert not res["correct"], res["checks"]
