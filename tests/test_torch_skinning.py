"""The port's skinning: plain version vs the TPU kernel, wrapper contract.

`skinning_reference` (the plain torch version that the CUDA kernel is
held to on the card) is compared with the Pallas kernel in interpret
mode and with the JAX einsum path, at atol 1e-4 (fp32 sums of 24 terms
in another order), including a V that is no multiple of the TPU tile.
The CUDA kernel itself runs only on the card: tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poco_tpu.ops.pallas_lbs import skinning_pallas
from poco_tpu.ops.rotation import axis_angle_to_rotmat
from poco_tpu_torch.ops import kernels
from poco_tpu_torch.ops.skinning import skinning, skinning_reference

ATOL = 1e-4


def _inputs(batch, num_verts, seed):
    rng = np.random.RandomState(seed)
    w = rng.rand(num_verts, 24).astype(np.float32) ** 4
    w /= w.sum(axis=1, keepdims=True)
    tfms = np.broadcast_to(np.eye(4, dtype=np.float32), (batch, 24, 4, 4)).copy()
    aa = (0.4 * rng.randn(batch * 24, 3)).astype(np.float32)
    tfms[:, :, :3, :3] = np.asarray(axis_angle_to_rotmat(jnp.asarray(aa))).reshape(
        batch, 24, 3, 3
    )
    tfms[:, :, :3, 3] = 0.1 * rng.randn(batch, 24, 3)
    vp = rng.randn(batch, num_verts, 3).astype(np.float32)
    return w, tfms, vp


def _jax_einsum_skinning(w, tfms, vp):
    """The XLA path of poco_tpu.smpl.lbs.lbs (lbs.py:177-186)."""
    b, v = vp.shape[:2]
    vt = jnp.einsum("vj,bjk->bvk", w, tfms.reshape(b, 24, 16)).reshape(b, v, 4, 4)
    return jnp.einsum("bvxy,bvy->bvx", vt[:, :, :3, :3], vp) + vt[:, :, :3, 3]


@pytest.mark.parametrize("batch,num_verts", [(2, 100), (3, 77), (1, 1)])
def test_reference_matches_pallas_interpret(batch, num_verts):
    w, tfms, vp = _inputs(batch, num_verts, seed=num_verts)
    port = skinning_reference(*map(torch.from_numpy, (w, tfms, vp)))
    ref = skinning_pallas(
        jnp.asarray(w), jnp.asarray(tfms), jnp.asarray(vp),
        vertex_tile=32, interpret=True,
    )
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("batch,num_verts", [(2, 6890), (4, 1001)])
def test_reference_matches_jax_einsum(batch, num_verts):
    w, tfms, vp = _inputs(batch, num_verts, seed=batch)
    port = skinning_reference(*map(torch.from_numpy, (w, tfms, vp)))
    ref = _jax_einsum_skinning(jnp.asarray(w), jnp.asarray(tfms), jnp.asarray(vp))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_wrapper_on_cpu_takes_plain_version_without_counting():
    args = [torch.from_numpy(a) for a in _inputs(2, 50, seed=1)]
    before = skinning.launches
    out = skinning(*args)
    assert skinning.launches == before
    torch.testing.assert_close(out, skinning_reference(*args), rtol=0, atol=0)


def test_wrapper_never_falls_back_off_the_cpu():
    """A tensor that is not on the CPU gets the kernel or an error; here
    a meta tensor (not CUDA) must raise, not run the plain version."""
    w, tfms, vp = (torch.from_numpy(a) for a in _inputs(2, 50, seed=2))
    with pytest.raises(ValueError, match="one CUDA device"):
        skinning(w, tfms, vp.to("meta"))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.nvcc_path()


def test_library_path_follows_source(monkeypatch, tmp_path):
    path = kernels.library_path("skinning")
    assert path.parent == kernels.BUILD_DIR and path.name.startswith("libskinning-")
    src = tmp_path / "skinning.cu"
    src.write_text((kernels.CSRC_DIR / "skinning.cu").read_text() + "\n// edit\n")
    monkeypatch.setattr(kernels, "CSRC_DIR", tmp_path)
    assert kernels.library_path("skinning") != path
