"""The port's checkpoint manager (``repro_torch.checkpoint.manager``)
against the reference's (``repro.checkpoint.manager``) on the CPU: the
reference's four behaviours on the port (atomic round trip, a corrupted
step falls back, GC keeps the newest, async save), an async snapshot that
a later in-place update cannot reach, bf16 leaves, and the on-disk format
read both ways with the same leaf names and CRCs."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platform_name", "cpu")

from repro.checkpoint.manager import CheckpointManager as JManager

from repro_torch.checkpoint.manager import CheckpointManager as TManager

# One PyTorch thread a process: the tier-1 run puts six pytest workers on
# the machine's cores, where PyTorch's default of an OpenMP thread per core
# makes each worker's ops wait on the others' (tens of times slower).
torch.set_num_threads(1)


def _tree():
    return {"a": torch.arange(10, dtype=torch.float32),
            "nested": {"b": torch.ones((3, 4)),
                       "h": torch.arange(6, dtype=torch.float32
                                         ).to(torch.bfloat16)},
            "layers": [{"w": torch.full((2, 2), 3.0)},
                       {"w": torch.full((2, 2), 4.0)}],
            "step": torch.tensor(7, dtype=torch.int32)}


def _equal(a, b) -> None:
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_atomic_roundtrip(tmp_path):
    mgr = TManager(tmp_path)
    tree = _tree()
    mgr.save(5, tree, extra={"step": 5})
    assert not list(tmp_path.glob("*.tmp"))
    restored, extra = mgr.restore(tree)
    assert extra["step"] == 5
    _equal(restored, tree)


def test_corruption_falls_back(tmp_path):
    mgr = TManager(tmp_path)
    tree = {"a": torch.arange(4, dtype=torch.float32)}
    mgr.save(1, tree)
    mgr.save(2, {"a": tree["a"] + 1})
    victim = next((tmp_path / "step_00000002").glob("*.npy"))
    np.save(victim, np.load(victim) + 99)
    restored, _ = mgr.restore(tree)
    assert torch.equal(restored["a"], torch.arange(4, dtype=torch.float32))


def test_gc_keeps_recent(tmp_path):
    mgr = TManager(tmp_path, keep=2)
    tree = {"a": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]


def test_async_save(tmp_path):
    mgr = TManager(tmp_path)
    tree = {"a": torch.arange(6, dtype=torch.float32)}
    mgr.save_async(7, tree, extra={"step": 7})
    mgr.wait()
    assert mgr.latest_step() == 7


def test_async_snapshot_is_a_copy(tmp_path):
    """The port updates parameters in place (AdamW): a snapshot taken by
    ``save_async`` must hold the values at the call, whatever happens to
    the tensors while the writer runs."""
    mgr = TManager(tmp_path)
    tree = _tree()
    want = {"a": tree["a"].clone(), "h": tree["nested"]["h"].clone()}
    mgr.save_async(3, tree, extra={"step": 3})
    with torch.no_grad():
        tree["a"].add_(100.0)
        tree["nested"]["h"].mul_(-1)
    mgr.wait()
    restored, _ = mgr.restore(tree)
    assert torch.equal(restored["a"], want["a"])
    assert torch.equal(restored["nested"]["h"], want["h"])


def test_bf16_leaf_round_trips(tmp_path):
    mgr = TManager(tmp_path)
    h = torch.tensor([1.0, -2.5, 3.14159, 1e-20, 65504.0, float("inf")]
                     ).to(torch.bfloat16)
    mgr.save(1, {"h": h})
    index = json.loads((tmp_path / "step_00000001" / "index.json"
                        ).read_text())
    assert index["leaves"]["h"]["dtype"] == "bfloat16"
    restored, _ = mgr.restore({"h": torch.zeros(6, dtype=torch.bfloat16)})
    assert restored["h"].dtype == torch.bfloat16
    assert torch.equal(restored["h"].view(torch.int16), h.view(torch.int16))


def _jax_tree(t):
    def conv(x):
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(x.numpy())
    return jax.tree.map(conv, t, is_leaf=torch.is_tensor)


def _index(d) -> dict:
    return json.loads((d / "index.json").read_text())


def test_format_is_the_references_both_ways(tmp_path):
    """A tree written by the port restores through the reference's manager
    and one written by the reference through the port's: each index has
    the same leaf names, files, shapes, dtypes and CRCs, and every value
    comes back (bf16 leaves as their raw 2-byte words on the reference's
    side, which reads no bf16 either)."""
    tree = _tree()
    jtree = _jax_tree(tree)
    TManager(tmp_path / "port").save(3, tree, extra={"step": 3})
    JManager(tmp_path / "ref").save(3, jtree, extra={"step": 3})
    ip = _index(tmp_path / "port" / "step_00000003")
    ir = _index(tmp_path / "ref" / "step_00000003")
    assert ip == ir
    assert sorted(ip["leaves"]) == ["a", "layers/0/w", "layers/1/w",
                                    "nested/b", "nested/h", "step"]

    # the port's files through the reference
    jres, extra = JManager(tmp_path / "port").restore(jtree)
    assert extra == {"step": 3}
    for k, v in jax.tree_util.tree_flatten_with_path(jres)[0]:
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in k)
        want = jax.tree_util.tree_flatten_with_path(jtree)[0]
        ref = dict(("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                             for p in kk), vv) for kk, vv in want)[name]
        assert np.asarray(v).tobytes() == np.asarray(ref).tobytes(), name

    # the reference's files through the port
    tres, extra = TManager(tmp_path / "ref").restore(tree)
    assert extra == {"step": 3}
    _equal(tres, tree)


def test_restore_onto_a_device(tmp_path):
    """The reference's ``shardings`` becomes a target device: leaves come
    back there (the CPU here)."""
    mgr = TManager(tmp_path)
    mgr.save(1, {"a": torch.ones(3)})
    restored, _ = mgr.restore({"a": torch.zeros(3)}, device="cpu")
    assert restored["a"].device.type == "cpu"
    with pytest.raises(FileNotFoundError):
        TManager(tmp_path / "empty").restore({"a": torch.zeros(3)})
