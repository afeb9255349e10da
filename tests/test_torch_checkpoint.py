"""The port's checkpoints (``utils/checkpoint.py``) against the JAX
package's, on the CPU: archives cross between the packages both ways.

The same object gives the same SHA-256 content digest in both packages
(the manifest names the JAX package's types, the field order and the
array keys are its), each package's ``load_fitted`` verifies and loads
the other's archive with every array ``array_equal``, and a tampered or
truncated archive, written by either package or by the ``fs:corrupt_npz``
chaos scope, is refused with each package's ``CheckpointCorrupt``.
Shapes are the JAX serving rig's synthetic forest (T=8, D=3, p=4, 8
bins, 50 training rows).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ate_replication_causalml_torch.models import causal_forest as tcf
from ate_replication_causalml_torch.resilience import chaos as tchaos
from ate_replication_causalml_torch.resilience.errors import CheckpointCorrupt as TCorrupt
from ate_replication_causalml_torch.utils import checkpoint as tck
from ate_replication_causalml_tpu.models import causal_forest as jcf
from ate_replication_causalml_tpu.resilience import chaos as jchaos
from ate_replication_causalml_tpu.resilience.errors import CheckpointCorrupt as JCorrupt
from ate_replication_causalml_tpu.utils import checkpoint as jck

T, D, N, P, NB = 8, 3, 50, 4, 8
FOREST_FIELDS = ("split_feat", "split_bin", "leaf_stats", "in_sample", "bin_edges")
FITTED_FIELDS = ("y_hat", "w_hat", "x", "y", "w")


def _arrays(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "split_feat": rng.integers(0, P, size=(T, D, 1 << D)).astype(np.int32),
        "split_bin": rng.integers(0, NB - 1, size=(T, D, 1 << D)).astype(np.int32),
        "leaf_stats": (np.abs(rng.normal(size=(T, 1 << D, 5))) + 0.5).astype(np.float32),
        "in_sample": rng.uniform(size=(T, N)) < 0.5,
        "bin_edges": np.sort(rng.normal(size=(P, NB - 1)), axis=1).astype(np.float32),
        "y_hat": rng.uniform(size=N).astype(np.float32),
        "w_hat": rng.uniform(0.1, 0.9, size=N).astype(np.float32),
        "x": rng.normal(size=(N, P)).astype(np.float32),
        "y": rng.normal(size=N).astype(np.float32),
        "w": (rng.uniform(size=N) < 0.5).astype(np.float32),
    }


def _objects(kind: str, seed: int = 0):
    """The same object in both packages: (jax, torch)."""
    a = _arrays(seed)
    jf = jcf.CausalForest(**{k: jnp.asarray(a[k]) for k in FOREST_FIELDS}, ci_group_size=2)
    tf = tcf.CausalForest(**{k: torch.from_numpy(a[k]) for k in FOREST_FIELDS}, ci_group_size=2)
    if kind == "forest":
        return jf, tf
    return (jcf.FittedCausalForest(jf, **{k: jnp.asarray(a[k]) for k in FITTED_FIELDS}),
            tcf.FittedCausalForest(tf, **{k: torch.from_numpy(a[k]) for k in FITTED_FIELDS}))


def _digest(path: str) -> str:
    with np.load(path) as z:
        return bytes(z["__sha256__"]).decode()


def _fields(obj) -> dict:
    """Every array of a (fitted) forest as numpy, by field path."""
    forest = getattr(obj, "forest", obj)
    out = {k: np.asarray(getattr(forest, k)) for k in FOREST_FIELDS}
    if forest is not obj:
        out.update({k: np.asarray(getattr(obj, k)) for k in FITTED_FIELDS})
    return out


@pytest.mark.parametrize("kind", ["forest", "fitted"])
def test_archives_cross_both_ways_with_equal_digests(tmp_path, kind):
    jobj, tobj = _objects(kind)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jck.save_fitted(jpath, jobj)
    tck.save_fitted(tpath, tobj)
    assert _digest(jpath) == _digest(tpath)
    with np.load(jpath) as zj, np.load(tpath) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        assert bytes(zj["__manifest__"]) == bytes(zt["__manifest__"])
    want = _fields(jobj)
    # The port loads the JAX package's archive, the JAX package the port's.
    from_jax = tck.load_fitted(jpath, device="cpu")
    from_torch = jck.load_fitted(tpath, device=False)
    assert type(from_jax) is type(tobj) and type(from_torch) is type(jobj)
    for got in (_fields(from_jax), _fields(from_torch)):
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    forest = getattr(from_jax, "forest", from_jax)
    assert forest.ci_group_size == 2 and forest.split_feat.device.type == "cpu"
    # device=False: host numpy, as the JAX package's.
    plain = tck.load_fitted(jpath, device=False)
    assert isinstance(getattr(plain, "forest", plain).bin_edges, np.ndarray)


def _tamper(path: str) -> None:
    """A member rewritten as a valid archive: the zip layer sees nothing."""
    with np.load(path) as z:
        members = {k: z[k] for k in z.files}
    members["arr_2"] = members["arr_2"] + np.float32(1.0)
    np.savez_compressed(path, **members)


def _truncate(path: str) -> None:
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[: len(data) * 2 // 3])


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("damage", ["tamper", "truncate"])
def test_damaged_archive_refused_by_both(tmp_path, writer, damage):
    jobj, tobj = _objects("fitted", seed=1)
    path = str(tmp_path / "m.npz")
    (jck if writer == "jax" else tck).save_fitted(path, jobj if writer == "jax" else tobj)
    (_tamper if damage == "tamper" else _truncate)(path)
    match = "digest mismatch" if damage == "tamper" else "m.npz"
    with pytest.raises(JCorrupt, match=match):
        jck.load_fitted(path, device=False)
    with pytest.raises(TCorrupt, match=match):
        tck.load_fitted(path, device="cpu")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_chaos_corrupt_npz_refused_by_both(tmp_path, monkeypatch, writer):
    """``fs:corrupt_npz`` truncates the next archive either package
    writes; both packages refuse it, and the next write is clean."""
    monkeypatch.delenv("ATE_TPU_CHAOS", raising=False)
    jobj, tobj = _objects("forest", seed=2)
    mod, obj, ch = (jck, jobj, jchaos) if writer == "jax" else (tck, tobj, tchaos)
    path = str(tmp_path / "m.npz")
    with ch.override("fs:corrupt_npz"):
        mod.save_fitted(path, obj)
        with pytest.raises(JCorrupt, match="m.npz"):
            jck.load_fitted(path, device=False)
        with pytest.raises(TCorrupt, match="m.npz"):
            tck.load_fitted(path, device="cpu")
        mod.save_fitted(path, obj)  # budget spent: this write is clean
    assert np.array_equal(tck.load_fitted(path, device="cpu").leaf_stats.numpy(),
                          np.asarray(jobj.leaf_stats))


def test_manifest_types_outside_the_table_are_refused(tmp_path):
    """A manifest may name only the record types of ``JAX_TYPES``: the
    loader refuses anything else before importing it."""
    for qualname in ("os:system", "ate_replication_causalml_tpu.native:subprocess.Popen",
                     "ate_replication_causalml_tpu.serving.daemon:ServeConfig"):
        path = str(tmp_path / "evil.npz")
        manifest = json.dumps({"__dataclass__": qualname, "fields": {}}).encode()
        np.savez_compressed(path, __manifest__=np.frombuffer(manifest, dtype=np.uint8))
        with pytest.raises(ValueError, match="refusing"):
            tck.load_fitted(path, device=False)
    with pytest.raises(TypeError, match="checkpointable"):
        tck.save_fitted(str(tmp_path / "x.npz"), tchaos.ChaosConfig("", {}))
