"""The port's ``CheckpointManager`` (``repro_torch.checkpoint``): the
reference's ``tests/test_checkpoint.py`` checks on the port, and step
directories read across packages bit for bit in both directions."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.configs import get_arch
from repro.models.config import reduced
from repro.models.params import init_params as ref_init_params
from repro.optim import adamw_init as ref_adamw_init

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten
from repro_torch.models.params import params_from_numpy
from repro_torch.optim import adamw_init


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "layers": {"w": torch.from_numpy(
                       rng.normal(size=(4, 8, 8)).astype(np.float32)),
                   "b": torch.from_numpy(
                       rng.normal(size=(4, 8)).astype(np.float32))},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _leaves(tree):
    return [(k, np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor)
                           else v)) for k, v in _flatten(tree)]


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


# ------------------------------ the reference's tests/test_checkpoint.py

def test_roundtrip(tmp_path):
    m = CheckpointManager(tmp_path, async_save=False)
    t = _tree()
    m.save(10, t, extra={"data_step": 10})
    step, t2, extra = m.restore(t)
    assert step == 10 and extra == {"data_step": 10}
    _assert_same(t, t2)
    assert all(isinstance(v, torch.Tensor) for _, v in _flatten(t2))


def test_async_and_gc(tmp_path):
    m = CheckpointManager(tmp_path, keep_last_k=2, async_save=True)
    t = _tree()
    for s in (1, 2, 3, 4):
        m.save(s, t)
    m.wait()
    assert m.all_steps() == [3, 4]
    # no tmp dirs left behind
    assert not [p for p in os.listdir(tmp_path) if ".tmp-" in p]


def test_atomic_no_partial_state_visible(tmp_path):
    m = CheckpointManager(tmp_path, async_save=False)
    m.save(5, _tree())
    # simulate a crashed write: stray tmp dir must be ignored
    crash = tmp_path / "step_00000009.tmp-deadbeef"
    crash.mkdir()
    (crash / "manifest.json").write_text("{}")
    assert m.latest_step() == 5


def test_shape_mismatch_rejected(tmp_path):
    m = CheckpointManager(tmp_path, async_save=False)
    m.save(1, _tree())
    bad = {"layers": {"w": torch.zeros((2, 2)), "b": torch.zeros((4, 8))},
           "step": torch.tensor(0)}
    with pytest.raises((ValueError, KeyError)):
        m.restore(bad)


def test_save_snapshots_before_returning_and_wait_raises(tmp_path):
    """``save`` copies to host memory before it returns: the in-place
    optimizer may write the leaves while the thread serialises.  A
    failing write surfaces on ``wait``."""
    m = CheckpointManager(tmp_path, async_save=True)
    t = _tree()
    want = t["layers"]["w"].clone()
    m.save(1, t)
    t["layers"]["w"].add_(1.0)
    m.wait()
    _, back, _ = m.restore(t)
    assert torch.equal(back["layers"]["w"], want)
    (tmp_path / "blocker").write_text("")
    m.dir = tmp_path / "blocker"          # mkdir under a file fails
    m.save(2, t)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        m.wait()


def test_elastic_restore_across_device_lists(tmp_path):
    """Saved from leaves on a list of 8 devices, restored onto a list of
    4: every leaf is re-placed on the device its entry names."""
    rng = np.random.default_rng(4)
    eight, four = ["cpu"] * 8, ["cpu"] * 4
    tree = {f"w{i}": torch.from_numpy(rng.normal(size=(8, 4)).astype(
        np.float32)).to(eight[i]) for i in range(8)}
    CheckpointManager(tmp_path, async_save=False).save(3, tree)
    target = {f"w{i}": four[i % 4] for i in range(8)}
    step, back, _ = CheckpointManager(tmp_path).restore(tree,
                                                        shardings=target)
    assert step == 3
    _assert_same(tree, back)
    assert all(back[k].device == torch.device(target[k]) for k in back)
    _, back, _ = CheckpointManager(tmp_path).restore(tree, shardings="cpu")
    _assert_same(tree, back)


# ------------------------------------------------ across the two packages

@pytest.fixture(scope="module")
def train_state():
    """A reduced qwen3-8b ``(params, opt)`` state of the reference and
    the same values as the port's tensors."""
    cfg = reduced(get_arch("qwen3-8b"))
    rp = ref_init_params(cfg, seed=0)
    rstate = (rp, ref_adamw_init(rp))
    rng = np.random.default_rng(5)
    rstate = jax.tree.map(lambda a: a + jnp.asarray(
        rng.normal(size=a.shape), a.dtype) if a.ndim else a + 3, rstate)
    np_state = jax.tree.map(np.asarray, rstate)
    pp = params_from_numpy(np_state[0], device="cpu")
    opt = params_from_numpy(np_state[1], device="cpu")
    assert opt["step"].dtype == torch.int32 and opt["step"].dim() == 0
    return rstate, (pp, opt)


def test_port_state_restores_in_the_reference_bit_for_bit(tmp_path,
                                                          train_state):
    rstate, pstate = train_state
    CheckpointManager(tmp_path, async_save=False).save(
        4, pstate, extra={"data_step": 4})
    template = jax.tree.map(jnp.zeros_like, rstate)
    step, got, extra = RefManager(tmp_path).restore(template)
    assert step == 4 and extra == {"data_step": 4}
    want = jax.tree_util.tree_flatten_with_path(rstate)[0]
    back = jax.tree.leaves(got)
    assert len(want) == len(back)
    for (path, w), g in zip(want, back):
        assert np.asarray(g).dtype == np.asarray(w).dtype, path
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes(), path
    assert "1/step" in {k for k, _ in _flatten(pstate)}


def test_reference_state_restores_in_the_port_bit_for_bit(tmp_path,
                                                          train_state):
    rstate, pstate = train_state
    RefManager(tmp_path, async_save=False).save(6, rstate)
    template = (pstate[0], adamw_init(pstate[0]))
    step, got, _ = CheckpointManager(tmp_path).restore(template)
    assert step == 6
    _assert_same(pstate, got)
    assert got[1]["step"].dtype == torch.int32


def test_manifests_have_equal_keys_shapes_and_dtypes(tmp_path, train_state):
    rstate, pstate = train_state
    RefManager(tmp_path / "ref", async_save=False).save(2, rstate)
    CheckpointManager(tmp_path / "port", async_save=False).save(2, pstate)
    ref = json.loads((tmp_path / "ref" / "step_00000002" /
                      "manifest.json").read_text())
    port = json.loads((tmp_path / "port" / "step_00000002" /
                       "manifest.json").read_text())
    assert sorted(port) == sorted(ref)
    for k in ("step", "keys", "shapes", "dtypes", "extra", "n_hosts"):
        assert port[k] == ref[k], k
    assert sorted(os.listdir(tmp_path / "port" / "step_00000002")) == \
        sorted(os.listdir(tmp_path / "ref" / "step_00000002"))
