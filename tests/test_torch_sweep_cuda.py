"""The concurrent sweep engine on the card: worker streams, the cache's
cross-stream events, and the MICRO sweep in both modes. Every test here
is marked ``cuda`` and skips without a card.

This file imports no JAX, so it runs on a machine that has none; run it
there without the suite's JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sweep_cuda.py -q
"""

import dataclasses
import json
import os
import shutil

import pytest
import torch

from ate_replication_causalml_torch import pipeline as tp
from ate_replication_causalml_torch.data.pipeline import PrepConfig
from ate_replication_causalml_torch.ops import hist, lasso, pack, tree
from ate_replication_causalml_torch.scheduler import ArtifactSpec, StageSpec, SweepEngine

pytestmark = pytest.mark.cuda

# tests/test_torch_pipeline.py's MICRO configuration.
MICRO = dataclasses.replace(
    tp.SweepConfig().quick(), prep=PrepConfig(n_obs=1200), synthetic_pool=3000, dr_trees=16,
    dml_trees=16, cf_trees=16, cf_nuisance_trees=16, forest_depth=4, balance_iters=600,
    use_mesh=False)

# Every launch counter of the kernel wrappers: (wrapper, attribute).
COUNTERS = [(fn, attr) for fn in (hist.bin_histogram_batched, hist.bin_histogram_shared)
            for attr in ("launches", "partition_launches", "packed_launches")] + [
    (fn, "launches") for fn in (hist.node_sums, hist.node_sums_shared, pack.pack_codes,
                                tree.route_bits, tree.table_lookup, tree.route_advance,
                                tree.traverse, tree.leaf_record, lasso.cd_path)]


def _counts() -> list[int]:
    return [getattr(fn, attr) for fn, attr in COUNTERS]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the worker streams and kernels have no CPU mode")
    return torch.device("cuda")


# ~0.2 s of spinning at the H100's clocks: far longer than the host
# needs to schedule the consumers.
SLEEP_CYCLES = 400_000_000


def test_cross_stream_handoff_waits_for_the_fit(cuda):
    """A value fitted on one worker's stream and read on another's: the
    producer spins on its stream before it writes, so a consumer that did
    not wait on the cache's event would read the buffer unwritten."""
    n = 1 << 20
    streams = {}

    def fit(c):
        streams["producer"] = torch.cuda.current_stream(cuda)
        x = torch.zeros(n, device=cuda)
        torch.cuda._sleep(SLEEP_CYCLES)
        return x.fill_(7.0)

    def consume(name):
        def run(c):
            streams[name] = torch.cuda.current_stream(cuda)
            return float(c.get("a").sum().item())
        return run

    stages = [StageSpec("s0", run=consume("s0"), needs=("a",)),
              StageSpec("s1", run=consume("s1"), needs=("a",))]
    res = SweepEngine([ArtifactSpec("a", fit=fit)], stages, workers=2, prefetch=False,
                      device=cuda).run()
    assert res == {"s0": 7.0 * n, "s1": 7.0 * n}
    default = torch.cuda.current_stream(cuda)
    assert all(s != default for s in streams.values()), "a node ran on the caller's stream"
    assert any(streams[s] != streams["producer"] for s in ("s0", "s1")), \
        "no consumer ran on another stream than the producer's"
    # The window is real: the same read on another stream without the
    # event sees the buffer before the fill.
    a, b = torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)
    with torch.cuda.stream(a):
        x = torch.zeros(n, device=cuda)
    b.wait_stream(a)
    with torch.cuda.stream(a):
        torch.cuda._sleep(SLEEP_CYCLES)
        x.fill_(7.0)
    with torch.cuda.stream(b):
        early = float(x.sum().item())
    torch.cuda.synchronize(cuda)
    assert early == 0.0


def _stripped(out) -> list[dict]:
    with open(os.path.join(out, "results.jsonl")) as f:
        return [{k: v for k, v in json.loads(ln).items() if k != "seconds"} for ln in f]


@pytest.fixture(scope="module")
def card_sweeps(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = tmp_path_factory.mktemp("card_sweeps")
    out = {}
    for mode, kw in (("sequential", dict(scheduler="sequential")), ("concurrent", dict(workers=4))):
        before = _counts()
        rep = tp.run_sweep(MICRO, outdir=str(root / mode), plots=False, log=lambda s: None, **kw)
        out[mode] = (rep, [b - a for a, b in zip(before, _counts())])
    return root, out


def test_concurrent_micro_sweep_equals_sequential_on_card(cuda, card_sweeps):
    """Every row bit for bit, the journal's lines in the same order, the
    same launches of every kernel."""
    root, out = card_sweeps
    (seq, seq_launches), (conc, conc_launches) = out["sequential"], out["concurrent"]
    same = lambda a, b: tp._jsonsafe(a.to_dict()) == tp._jsonsafe(b.to_dict())
    assert same(conc.oracle, seq.oracle)
    for a, b in zip(conc.results, seq.results):
        assert a.status == "ok" and same(a, b), (a, b)
    assert _stripped(str(root / "concurrent")) == _stripped(str(root / "sequential"))
    assert conc_launches == seq_launches and sum(seq_launches) > 0


@pytest.mark.parametrize("source,kw", [("concurrent", dict(scheduler="sequential")),
                                       ("sequential", dict(workers=4))])
def test_cross_mode_resume_on_card_launches_nothing(cuda, card_sweeps, tmp_path, source, kw):
    root, out = card_sweeps
    dst = str(tmp_path / source)
    shutil.copytree(str(root / source), dst)
    before = _counts()
    again = tp.run_sweep(MICRO, outdir=dst, plots=False, log=lambda s: None, **kw)
    assert (again.computed, again.resumed) == (0, len(tp.SWEEP_METHODS) + 1)
    assert _counts() == before
