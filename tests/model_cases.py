"""Shared inputs of the LM-stack parity tests (test_torch_models.py,
test_torch_launch_serve.py, test_torch_train.py, test_torch_checkpoint.py):
reference parameter trees filled from a numpy seed, their conversion to the
port, comparison helpers, and the reference driver's one-device mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import model_zoo as RZ
from repro_torch import convert

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
# The audio encoder's leaves stay bf16 in an "fp32" run: the reference's
# _encode casts the frames to bf16, and with fp32 encoder weights its scan
# carry would change type (jax.lax.scan raises).
KEEP_BF16 = ("enc_groups", "enc_final_norm")


def _fill(rng, path, sds):
    """Leaf values by parameter name: norm scales and D near 1, dt_bias near
    -2, A_log and the conv near the reference's init, every other weight and
    bias N(0, 0.02^2). Random biases and scales are exercised, where the
    reference's init would leave them at 0 and 1."""
    name = str(path[-1].key) if hasattr(path[-1], "key") else str(path[-1])
    z = rng.standard_normal(sds.shape).astype(np.float32)
    if name in ("scale", "D"):
        x = 1.0 + 0.1 * z
    elif name == "dt_bias":
        x = -2.0 + 0.5 * z
    elif name in ("A_log", "conv_w"):
        x = 0.1 * z
    else:
        x = 0.02 * z
    return jnp.asarray(x, sds.dtype)


def ref_params(cfg, seed=0):
    """The reference's parameter tree (shapes and dtypes of its init, bf16
    weights), values from numpy's generator seeded with `seed`."""
    shapes = jax.eval_shape(lambda k: RZ.init_params(cfg, k), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(lambda p, s: _fill(rng, p, s), shapes)


def upcast(tree):
    """Every leaf as fp32 (the values stay bf16-representable), but the audio
    encoder's (KEEP_BF16)."""
    return {k: v if k in KEEP_BF16 else jax.tree.map(lambda a: a.astype(jnp.float32), v)
            for k, v in tree.items()}


def to_port(cfg, tree):
    return convert.model_params_from_jax(cfg, jax.device_get(tree), "cpu")


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, exp, tol, what=""):
    np.testing.assert_allclose(f32(got), f32(exp), err_msg=what, **tol)


def one_device_mesh():
    """The reference driver's data x model mesh over one device, the port's
    layout. Its best-fit mesh over the conftest's 4 host devices would shard
    the step 4 ways, and XLA's in-process CPU collectives have hung such a
    step under a loaded test run."""
    from repro.compat import AxisType, make_mesh

    return make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2, devices=jax.devices()[:1])
