"""raft_tpu_torch core against raft_tpu: the v4 envelope both ways, CRC
damage, bitsets, resources, and the import guard (the port never imports
JAX or raft_tpu)."""
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raft_tpu.core import serialize as jser
from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu_torch.core import serialize as tser
from raft_tpu_torch.core.bitset import Bitset as TBitset
from raft_tpu_torch.core.errors import CorruptIndexError, LogicError
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import ivf_flat as tivf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(16, 24)).astype(np.float32) * 3
    return (centers[rng.integers(0, 16, 1500)] + rng.normal(size=(1500, 24))).astype(np.float32)


@pytest.fixture(scope="module")
def jax_ivf(data):
    return jivf.build(data, jivf.IvfFlatIndexParams(n_lists=16))


_IVF_FIELDS = ("centers", "list_data", "list_indices", "list_sizes", "list_norms", "center_rank")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_jax_saved_ivf_flat_loads_in_port(jax_ivf):
    buf = io.BytesIO()
    jivf.save(jax_ivf, buf)
    buf.seek(0)
    ti = tivf.load(buf, device="cpu")
    for f in _IVF_FIELDS:
        a, b = np.asarray(getattr(jax_ivf, f)), _np(getattr(ti, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (ti.metric, ti.size, ti.list_cap_factor) == (
        jax_ivf.metric, jax_ivf.size, jax_ivf.list_cap_factor)


def test_port_saved_ivf_flat_loads_in_jax(jax_ivf, tmp_path):
    buf = io.BytesIO()
    jivf.save(jax_ivf, buf)
    buf.seek(0)
    ti = tivf.load(buf, device="cpu")
    path = tivf.save_path(ti, str(tmp_path / "idx.bin"))
    back = jivf.load_path(path)
    for f in _IVF_FIELDS:
        assert np.array_equal(np.asarray(getattr(back, f)), _np(getattr(ti, f))), f
    # byte for byte: the port writes exactly what JAX writes
    out = io.BytesIO()
    jivf.save(jax_ivf, out)
    with open(path, "rb") as fh:
        assert fh.read() == out.getvalue()


@pytest.mark.parametrize("metric", ["sqeuclidean", "cosine", "inner_product"])
def test_brute_force_round_trip_both_ways(data, metric):
    jidx = jbf.build(data, metric=metric)
    buf = io.BytesIO()
    jbf.save(jidx, buf)
    buf.seek(0)
    tidx = tbf.load(buf, device="cpu")
    assert np.array_equal(_np(tidx.dataset), np.asarray(jidx.dataset))
    assert (tidx.norms is None) == (jidx.norms is None)
    if jidx.norms is not None:
        assert np.array_equal(_np(tidx.norms), np.asarray(jidx.norms))
    out = io.BytesIO()
    tbf.save(tidx, out)
    assert out.getvalue() == buf.getvalue()
    out.seek(0)
    back = jbf.load(out)
    assert np.array_equal(np.asarray(back.dataset), _np(tidx.dataset))
    assert back.metric == tidx.metric and back.metric_arg == tidx.metric_arg


def test_from_numpy_matches_load(jax_ivf):
    arrays = {f: np.asarray(getattr(jax_ivf, f)) for f in _IVF_FIELDS}
    ti = tivf.from_numpy(arrays, jax_ivf.metric, jax_ivf.size, jax_ivf.list_cap_factor, device="cpu")
    for f in _IVF_FIELDS:
        assert np.array_equal(_np(getattr(ti, f)), arrays[f]), f


@pytest.mark.parametrize("where", ["payload", "truncated"])
def test_corrupt_snapshot_raises(jax_ivf, where):
    buf = io.BytesIO()
    jivf.save(jax_ivf, buf)
    raw = bytearray(buf.getvalue())
    if where == "payload":
        raw[-100] ^= 0x01
    else:
        raw = raw[:-10]
    with pytest.raises(CorruptIndexError):
        tivf.load(io.BytesIO(bytes(raw)), device="cpu")


def test_bf16_array_frames_cross_packages():
    import jax.numpy as jnp

    x = np.random.default_rng(0).normal(size=(5, 7)).astype(np.float32)
    buf = io.BytesIO()
    jser.serialize_array(buf, jnp.asarray(x, jnp.bfloat16))
    buf.seek(0)
    t = tser.deserialize_array(buf)
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(), np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32))
    out = io.BytesIO()
    tser.serialize_array(out, t)
    assert out.getvalue() == buf.getvalue()


@pytest.mark.parametrize("size", [1, 31, 32, 33, 100])
def test_bitset_words_match(size):
    import jax.numpy as jnp

    rng = np.random.default_rng(size)
    mask = rng.random(size) < 0.6
    jb = JBitset.from_mask(jnp.asarray(mask))
    tb = TBitset.from_mask(torch.from_numpy(mask))
    assert np.array_equal(tb.words(), np.asarray(jb.bits))
    idx = rng.integers(0, size, 5)
    assert np.array_equal(tb.unset(torch.from_numpy(idx)).words(),
                          np.asarray(jb.unset(jnp.asarray(idx)).bits))
    assert np.array_equal(tb.flip().words(), np.asarray(jb.flip().bits))
    assert np.array_equal(TBitset.create(size, device="cpu").words(),
                          np.asarray(JBitset.create(size).bits))
    assert tb.count() == int(jb.count())
    q = rng.integers(0, size, 9)
    assert np.array_equal(tb.test(torch.from_numpy(q)).numpy(), np.asarray(jb.test(jnp.asarray(q))))
    assert np.array_equal(TBitset.from_numpy_words(np.asarray(jb.bits), size).to_mask().numpy(), mask)


def test_resources_default_to_cuda():
    if torch.cuda.is_available():
        assert Resources().device.type == "cuda"
    else:
        with pytest.raises(LogicError):
            Resources()
    cpu = ensure_resources(device="cpu")
    assert cpu.device.type == "cpu" and cpu.stream is None


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import raft_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(raft_tpu_torch.__path__, 'raft_tpu_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'raft_tpu' or k.startswith('raft_tpu.'))\n"
        "print(len(mods))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
