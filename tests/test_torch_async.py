"""The search loop's chunked termination and the asynchronous dispatch
worker, on the CPU.

``run_eager`` reads the done flag once per chunk of ``k`` steps; a done
pair is frozen, so the output dict (``ged``/``similar``, ``exact``,
``lower_bound``, ``upper_bound``, ``iterations``, ``expanded``,
``best_img``, ``floor``) must equal the reference's
``repro.core.engine.api.dispatch_packed`` (its ``run_pair`` ``vmap``-ed
over the batch) bit for bit for every ``k``, and the flag is read at most
``ceil(iterations / k) + 1`` times a batch.  The worker that runs batches
off the caller's thread on the card (``DeviceWorker``) is driven here on
the CPU: ``ready`` never blocks, ``result`` is cached, and a worker's
exception comes back with its type and message.  The ``"auto"`` backend
gives the same outcomes with and without overlap when its batches run on
such a worker.
"""

import math
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.engine.api import dispatch_packed as ref_dispatch  # noqa: E402
from repro.core.engine.search import EngineConfig as RefConfig  # noqa: E402
from repro.core.engine.tensor_graphs import pack_pairs as ref_pack  # noqa: E402
from repro.data.graphs import aids_like_graph, perturb  # noqa: E402

from repro_torch import ged  # noqa: E402
from repro_torch.core.engine import api as engine_api  # noqa: E402
from repro_torch.core.engine import search  # noqa: E402
from repro_torch.core.engine.search import EngineConfig  # noqa: E402
from repro_torch.core.engine.tensor_graphs import (  # noqa: E402
    from_reference, to_device)
from repro_torch.ged.exec import Executor, PendingBatch  # noqa: E402
from repro_torch.kernels.autotune import KernelDispatch  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

MAX_ITERS = 10
KW = dict(pool=32, expand=4, max_iters=MAX_ITERS)
FUSED = KernelDispatch(lsa_fused=True, bma_fused=True, merge_fused=True)


def _pairs(seed, count, n_lo, n_hi):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        g = aids_like_graph(rng, int(rng.integers(n_lo, n_hi + 1)),
                            n_vlabels=6, n_elabels=3)
        out.append((g, perturb(rng, g, int(rng.integers(0, 6)),
                               n_vlabels=6, n_elabels=3)))
    return out


@pytest.fixture(scope="module")
def batch():
    packed = ref_pack(_pairs(32, 8, 9, 14), slots=16)
    return packed, np.full(8, 2.0, dtype=np.float32)


@pytest.fixture(scope="module")
def reference(batch):
    packed, taus = batch
    return {v: {k: np.asarray(x) for k, x in ref_dispatch(
        packed, taus, RefConfig(**KW), v).items()} for v in (False, True)}


def _run(batch, verification, chunk, **kw):
    packed, taus = batch
    dev = to_device(from_reference(packed), "cpu")
    return search.run_eager(dev, torch.as_tensor(taus),
                            EngineConfig(**{**KW, **kw}), verification,
                            chunk=chunk)


@pytest.mark.parametrize("verification", [False, True])
@pytest.mark.parametrize("chunk", [1, 2, 5, MAX_ITERS + 6])
def test_chunked_loop_equals_reference(batch, reference, monkeypatch, chunk,
                                       verification):
    """Every output key bit-equal to the reference's for every chunk
    length; the done flag read (``bool`` or ``item`` of a tensor) at most
    once a chunk, plus the read that ends the loop."""
    reads = []
    real_bool, real_item = torch.Tensor.__bool__, torch.Tensor.item

    def counted_bool(t):
        reads.append("bool")
        return real_bool(t)

    def counted_item(t):
        reads.append("item")
        return real_item(t)

    monkeypatch.setattr(torch.Tensor, "__bool__", counted_bool)
    monkeypatch.setattr(torch.Tensor, "item", counted_item)
    out = _run(batch, verification, chunk)
    monkeypatch.undo()
    want = reference[verification]
    got = {k: v.numpy() for k, v in out.items()}
    assert set(got) == set(want)
    assert len(set(want["iterations"].tolist())) > 2   # pairs end apart
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), (k, got[k], want[k])
    iterations = int(want["iterations"].max())
    assert 0 < len(reads) <= math.ceil(iterations / chunk) + 1, \
        (reads, iterations)


def test_steps_after_every_pair_is_done_change_nothing(batch):
    """A batch whose pairs are all done goes through ``_step`` with every
    kernel family on (the CPU twins' gathers check their indices): the
    carry comes back unchanged, bit for bit."""
    packed, taus = batch
    dev = to_device(from_reference(packed), "cpu")
    cfg = EngineConfig(dispatch=FUSED, **KW)
    taus_t = torch.as_tensor(taus)
    pc, c, n, taus_t = search._init(dev, taus_t, cfg, False)
    while not bool(c.done.all()):
        c = search._step(pc, cfg, c, n, taus_t, False)
    after = c
    for _ in range(3):
        after = search._step(pc, cfg, after, n, taus_t, False)
    for a, b in zip(search._leaves(c), search._leaves(after)):
        assert torch.equal(a, b)


def test_a_capture_tallies_launches_that_replays_add():
    kops.reset_launch_counts()
    with kops.capture_tally() as tally:
        kops._count("reduced_top2")
        kops._count("merge_ranks")
    assert tally["reduced_top2"] == tally["merge_ranks"] == 1
    assert sum(kops.launch_counts().values()) == 0
    kops.add_launches(tally)
    kops.add_launches(tally)
    counts = kops.launch_counts()
    assert counts["reduced_top2"] == counts["merge_ranks"] == 2
    kops._count("lsa_children")
    assert kops.launch_counts()["lsa_children"] == 1
    kops.reset_launch_counts()


# ------------------------------------------------------ the async worker

def _submit(worker, batch, verification=False):
    packed, taus = batch
    dev = to_device(from_reference(packed), "cpu")
    return worker.submit(dev, torch.as_tensor(taus), EngineConfig(**KW),
                         verification)


def test_worker_ready_never_blocks_and_result_is_cached(batch, reference,
                                                        monkeypatch):
    gate = threading.Event()
    real = engine_api.run_batch

    def gated(*args):
        gate.wait(30)
        return real(*args)

    monkeypatch.setattr(engine_api, "run_batch", gated)
    worker = engine_api.DeviceWorker("cpu")
    pending = PendingBatch(_submit(worker, batch), flags={})
    t0 = time.perf_counter()
    assert not pending.ready()
    assert time.perf_counter() - t0 < 1.0
    gate.set()
    out = pending.result()
    assert pending.ready() and pending.result() is out
    for k, want in reference[False].items():
        assert np.array_equal(out[k], want), k


def test_worker_exception_keeps_its_type_and_message(batch, monkeypatch):
    msg = "CUDA kernel lsa_children failed at or before its launch: boom"

    def broken(*args):
        raise RuntimeError(msg)

    monkeypatch.setattr(engine_api, "run_batch", broken)
    pending = PendingBatch([_submit(engine_api.DeviceWorker("cpu"), batch)])
    with pytest.raises(RuntimeError) as info:
        pending.result()
    assert type(info.value) is RuntimeError and str(info.value) == msg
    assert pending.ready()


def test_start_packed_is_for_the_card():
    with pytest.raises(ValueError, match="dispatch_packed"):
        engine_api.start_packed(None, [], EngineConfig(), False,
                                device="cpu")


@pytest.mark.parametrize("overlap", [True, False])
def test_auto_on_a_worker_equals_the_synchronous_run(monkeypatch, overlap):
    """``GedEngine("auto")``'s batches run on a CPU worker, as on the card:
    the outcomes and counters equal the synchronous run's, with and
    without overlap."""
    rng = np.random.default_rng(31)
    pairs = [tuple((x.vlabels.tolist(), list(x.edges())) for x in p)
             for p in _pairs(31, 10, 5, 10)]
    pairs += [(pairs[0][0], ([0] * 6, [(i, i + 1, 1) for i in range(5)]))]
    rng.shuffle(pairs)
    rungs = ((4, 1, 2), (8, 2, 4))

    def engine():
        eng = ged.GedEngine("auto", device="cpu", cache=False,
                            overlap=overlap)
        eng._backend.scheduler.rungs = rungs
        return eng

    def key(o):
        return (o.ged, o.certified, o.lower_bound, o.upper_bound,
                o.stats.get("rung"))

    sync = engine()
    want = [key(o) for o in sync.compute(pairs)]
    worker = engine_api.DeviceWorker("cpu")
    threads = set()
    real = engine_api.run_batch

    def on_worker(*args):
        threads.add(threading.current_thread().name)
        return real(*args)

    def dispatch(self, packed, taus, cfg, verification):
        return worker.submit(
            to_device(packed, self.device),
            torch.as_tensor(np.asarray(taus, dtype=np.float32)), cfg,
            verification)

    monkeypatch.setattr(engine_api, "run_batch", on_worker)
    monkeypatch.setattr(Executor, "_dispatch", dispatch)
    eng = engine()
    got = [key(o) for o in eng.compute(pairs)]
    assert got == want
    assert threads and threading.current_thread().name not in threads
    for k in ("pairs", "escalated", "host_solved", "batches", "dispatches"):
        assert eng.stats[k] == sync.stats[k], k
    assert eng.stats["host_solved"] >= 1
