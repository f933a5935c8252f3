"""The port's row-sharded scale space (sift_pyocl_tpu_torch/parallel/
spatial.py) on CPU stand-in devices, against the JAX package's
sharded_scale_space on its virtual CPU devices and against the port's
single-device plain pyramid (tests/test_spatial.py's case)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sift_pyocl_tpu.config import SiftConfig as JaxConfig
from sift_pyocl_tpu.parallel.spatial import sharded_scale_space as jax_sharded
from sift_pyocl_tpu.utils.testimage import synthetic_scene

from sift_pyocl_tpu_torch import SiftConfig
from sift_pyocl_tpu_torch.ops.pyramid import build_scale_space
from sift_pyocl_tpu_torch.parallel import join_rows, make_frames_mesh, sharded_scale_space
from _torch_threads import _one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
KW = dict(conv_backend="xla", kp_per_octave_cap=256)


def _mesh(n: int):
    return make_frames_mesh(devices=[CPU] * n, axis="rows")


def _assert_pyramids_close(got, want):
    for o, ((gb, gd), (wb, wd)) in enumerate(zip(got, want)):
        b, d = join_rows(gb), join_rows(gd)
        wb, wd = np.asarray(wb), np.asarray(wd)
        assert b.shape == wb.shape and d.shape == wd.shape, f"octave {o}"
        np.testing.assert_allclose(b.numpy(), wb, atol=2e-3, err_msg=f"octave {o}")
        np.testing.assert_allclose(d.numpy(), wd, atol=4e-3, err_msg=f"octave {o}")


def test_sharded_scale_space_matches_jax_and_plain():
    """tests/test_spatial.py's case, synthetic_scene((256, 192), n_blobs=25,
    seed=2) on 4 stand-in devices: every octave's joined blurs within 2e-3
    and DoGs within 4e-3 of JAX's sharded pyramid on 4 virtual devices (the
    same octave count) and of the port's plain single-device pyramid."""
    img = synthetic_scene((256, 192), n_blobs=25, seed=2)
    got = sharded_scale_space(img, SiftConfig(**KW), _mesh(4))
    want = jax_sharded(jnp.asarray(img), JaxConfig(**KW),
                       Mesh(np.array(jax.devices()[:4]), ("rows",)))
    assert len(got) == len(want) == 3
    _assert_pyramids_close(got, want)
    _assert_pyramids_close(got, build_scale_space(torch.from_numpy(img), SiftConfig(**KW),
                                                  plain=True))


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_sharded_scale_space_matches_plain(n_dev):
    """The same frame on 1, 2 and 8 shards (4, 4 and 2 octaves by the
    octave rule) against the plain pyramid, to the same tolerances."""
    img = synthetic_scene((256, 192), n_blobs=25, seed=2)
    got = sharded_scale_space(img, SiftConfig(**KW), _mesh(n_dev))
    assert len(got) == {1: 4, 2: 4, 8: 2}[n_dev]
    _assert_pyramids_close(got, build_scale_space(torch.from_numpy(img), SiftConfig(**KW),
                                                  plain=True))


def test_sharded_scale_space_is_actually_sharded():
    """tests/test_spatial.py::test_sharded_scale_space_is_actually_sharded:
    four shards, shard i on the mesh's device i with rows [64 i, 64 i + 64)."""
    img = synthetic_scene((256, 192), n_blobs=10, seed=0)
    mesh = _mesh(4)
    (blurs, dogs), = sharded_scale_space(img, SiftConfig(**KW), mesh, n_oct=1)
    assert len(blurs) == len(dogs) == 4
    for i, (b, d) in enumerate(zip(blurs, dogs)):
        assert b.device == mesh.devices[i] and d.device == mesh.devices[i]
        assert b.shape == (6, 64, 192) and d.shape == (5, 64, 192)
    plain = build_scale_space(torch.from_numpy(img), SiftConfig(**KW), plain=True)[0][0]
    for i, b in enumerate(blurs):
        np.testing.assert_allclose(b.numpy(), plain[:, 64 * i:64 * (i + 1)].numpy(), atol=2e-3)


def test_sharded_scale_space_checks_its_input():
    """An H that does not shard raises (as JAX's assert does), and so do a
    mesh without the axis, a doubled input, and a halo wider than a shard."""
    img = synthetic_scene((250, 192), n_blobs=10, seed=0)
    with pytest.raises(ValueError, match="not shardable"):
        sharded_scale_space(img, SiftConfig(**KW), _mesh(4), n_oct=2)
    with pytest.raises(AssertionError, match="not shardable"):
        jax_sharded(jnp.asarray(img), JaxConfig(**KW),
                    Mesh(np.array(jax.devices()[:4]), ("rows",)), n_oct=2)
    img = synthetic_scene((256, 192), n_blobs=10, seed=0)
    with pytest.raises(ValueError, match="no axis"):
        sharded_scale_space(img, SiftConfig(**KW), make_frames_mesh(devices=[CPU] * 4))
    with pytest.raises(ValueError, match="upscale2"):
        sharded_scale_space(img, SiftConfig(double_im_size=True, **KW), _mesh(4))
    with pytest.raises(ValueError, match="halo"):
        sharded_scale_space(img, SiftConfig(**KW), _mesh(4), n_oct=4)
