"""The port's reference RNG against the JAX package's, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclpathtracer_tpu.core import rng as jcore_rng
from oclpathtracer_tpu.integrators import parity as jparity
from oclpathtracer_tpu.kernels import rng as jrng
from oclpathtracer_tpu_torch.core import rng as core_rng
from oclpathtracer_tpu_torch.integrators import parity
from oclpathtracer_tpu_torch.kernels import rng

torch.set_num_threads(1)

PIDS = np.array([0, 1, 511, 262143, 2**31 - 1, 2**31, 2**31 + 12345, 2**32 - 1],
                np.uint64)
FRAMES = [0, 1, 3, 4095, 65536, 10**6]


@pytest.mark.parametrize("frame", FRAMES)
def test_seed_and_draws_bitwise(frame):
    s_j = jrng.seed_from(jnp.asarray(PIDS, jnp.uint32), jnp.uint32(frame))
    s_t = rng.seed_from(torch.from_numpy(PIDS.astype(np.int64)), frame)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j).astype(np.int64))
    for _ in range(8):
        s_j, u_j = jrng.next_float(s_j)
        s_t, u_t = rng.next_float(s_t)
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j).astype(np.int64))
        assert u_t.dtype == torch.float32
        np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))


def test_hash_u32_bitwise():
    x = np.array([0, 1, 12345, 2**31 - 1, 2**31, 2**32 - 1], np.uint64)
    np.testing.assert_array_equal(rng.hash_u32(torch.from_numpy(x.astype(np.int64))).numpy(),
                                  np.asarray(jrng.hash_u32(jnp.asarray(x, jnp.uint32))))


def test_int32_pid_wraps_like_uint32():
    """A negative int32 pixel id is its two's-complement u32, as in the kernels."""
    s_neg = rng.seed_from(torch.tensor([-1], dtype=torch.int64), 7)
    s_pos = rng.seed_from(torch.tensor([2**32 - 1], dtype=torch.int64), 7)
    assert torch.equal(s_neg, s_pos)


def test_core_ref_rng_bitwise():
    pid = np.arange(64, dtype=np.uint64) + 2**31 - 32
    s_j = jcore_rng.ref_seed(jnp.asarray(pid, jnp.uint32), jnp.uint32(9))
    s_t = core_rng.ref_seed(torch.from_numpy(pid.astype(np.int64)), 9)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j).astype(np.int64))
    np.testing.assert_array_equal(core_rng.ref_hash_u32(torch.tensor([9])).numpy(),
                                  np.asarray(jcore_rng.ref_hash_u32(jnp.uint32(9)))[None])
    for _ in range(4):
        s_j, u_j = jcore_rng.ref_next_float(s_j)
        s_t, u_t = core_rng.ref_next_float(s_t)
        np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))


def test_ref_uniforms_bitwise():
    pid = np.arange(300, dtype=np.int64) * 7
    us_j = jparity.ref_uniforms(jnp.asarray(pid, jnp.int32), 123, 10)
    us_t = parity.ref_uniforms(torch.from_numpy(pid), 123, 10)
    np.testing.assert_array_equal(us_t.numpy(), np.asarray(us_j))
