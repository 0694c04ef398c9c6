"""A whole run of the harness, on the CPU past its look for a card, with
the timed path broken underneath: each fault a training cell can have
makes ``correct`` false, and the sound path keeps it true."""
import json
import time

import pytest
import torch

from fabric_bench import run
from fabric_bench.tests.tiny import make_root

CELLS = ["sc2_15b_l4.gbin_packed.s2048", "dsmoe16b_l4.gbin_packed.s4096",
         "sc2_15b_l4.fp32.s2048"]


def _state_unchanged(monkeypatch):
    """The optimizer returns its state and leaves the parameters."""
    from repro_torch.optim import optimizers
    monkeypatch.setattr(optimizers.AdamW, "apply",
                        lambda self, params, grads, state, zero=None: state)


def _half_batch(monkeypatch):
    """Each worker's shard keeps its first half of rows (of tokens, for
    a single row): half of the batch left out, the mean over the rest."""
    from fabric_bench.reference.train import halve
    from repro_torch.fabric import session
    split = session._split_batch

    def half(batch, w):
        return [{k: halve(v) for k, v in s.items()} for s in split(batch, w)]
    monkeypatch.setattr(session, "_split_batch", half)


def _no_exchange(monkeypatch):
    """The aggregate is worker 0's own gradient."""
    from repro_torch.core import tree as T
    from repro_torch.fabric import session

    def own(ctx, gtree, policies, ef_states=None, layout=None):
        return T.map_leaves(lambda g: g[0], gtree), ef_states
    monkeypatch.setattr(session, "aggregate_tree_bucketed", own)


def _votes_inverted(monkeypatch):
    """Each vote of the backbone turned round where it is produced: its
    norm, and so every norm compared, stays as it was."""
    from fabric_bench.reference.train import group_of
    from repro_torch.core import tree as T
    from repro_torch.fabric import session
    aggregate = session.aggregate_tree_bucketed

    def inverted(*args, **kw):
        agg, ef = aggregate(*args, **kw)
        return T.unflatten([(p, -g if group_of(p) == "backbone" else g)
                            for p, g in T.flatten(agg)]), ef
    monkeypatch.setattr(session, "aggregate_tree_bucketed", inverted)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "no_exchange": _no_exchange}


def _run(root, workload, capsys):
    rc = run.main(["--workload", workload, "--seed", str(2 ** 31 + 3),
                   "--seconds", "0.2", "--trace", "0"], root=root,
                  device="cpu", t0=time.perf_counter())
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def root(tmp_path):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield make_root(tmp_path)
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(root, workload, capsys):
    result = _run(root, workload, capsys)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"train_tokens_per_s", "peak_mem_gib",
                                      "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(root, workload, fault, monkeypatch, capsys):
    FAULTS[fault](monkeypatch)
    result = _run(root, workload, capsys)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", CELLS[:2])
def test_inverted_vote_is_not_correct(root, workload, monkeypatch, capsys):
    _votes_inverted(monkeypatch)
    result = _run(root, workload, capsys)
    assert not result["correct"], result["checks"]
    vote = result["checks"]["vote_gap"]
    assert vote["value"] > vote["limit"], vote
