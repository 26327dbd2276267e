"""The port's int8 gradient compression with error feedback
(repro_torch.dist.compression) against repro.dist.compression, on the CPU.

The reference combines inside a mapped axis with `psum`; here it runs under
`jax.vmap(..., axis_name="d")`, where `psum` is a sum over the ranks' axis
0 and no second device is needed. The port takes the ranks' trees as a list.
The reference runs op by op, each step rounded as its source writes it:
compiled, XLA's CPU backend contracts the residual `t - q * scale` into a
fused multiply-add, which skips the rounding of `deq` (the residual of
27 of a 30-element fp32 leaf's elements one rounding apart). Tolerance: bit
for bit, every leaf (fp32, bf16, int32 with negative values), the mean and
every rank's new residual. The cases loop inside few test functions (ROADMAP,
"suite hazards": the count of collected tests sets pytest-xdist's first chunks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.dist import compression as RC
from repro_torch import convert
from repro_torch.dist import compression as PC


# The reference over the ranks on axis 0, op by op: (trees, residuals) -> (mean, residuals).
REFERENCE = jax.vmap(lambda t, e: RC.compressed_tree_psum(t, "d", e), axis_name="d")


def ranks_tree(rng, n):
    """Per-rank numpy leaves stacked on axis 0: fp32, bf16 (with a leaf of
    zeros, whose scale is the 1e-30 floor), and int32 with negatives."""
    return {
        "w": (rng.standard_normal((n, 6, 5)) * 0.1).astype(np.float32),
        "b": {"x": rng.standard_normal((n, 33)).astype(jnp.bfloat16),
              "zero": np.zeros((n, 4), jnp.bfloat16)},
        "count": rng.integers(-50, 50, (n, 7)).astype(np.int32),
    }


def port_trees(stacked, n):
    return [jax.tree.map(lambda a, r=r: convert._tensor(np.asarray(a)[r], "cpu"), stacked) for r in range(n)]


def assert_bitwise(got, exp, what):
    exp = np.asarray(exp)
    g = got.detach()
    if g.dtype == torch.bfloat16:
        g = g.view(torch.uint16).numpy().view(jnp.bfloat16)
    else:
        g = g.numpy()
    assert g.dtype == exp.dtype, what
    assert g.shape == exp.shape, what
    np.testing.assert_array_equal(g.reshape(-1).view(np.uint8), exp.reshape(-1).view(np.uint8), err_msg=str(what))


def test_init_error_state_matches_reference():
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: a[0], ranks_tree(rng, 1))
    exp = RC.init_error_state(jax.tree.map(jnp.asarray, tree))
    got = PC.init_error_state(jax.tree.map(lambda a: convert._tensor(a, "cpu"), tree))
    for key in ("w", "count"):
        assert_bitwise(got[key], exp[key], key)
    assert_bitwise(got["b"]["x"], exp["b"]["x"], "b.x")
    assert got["count"].shape == () and got["count"].dtype == torch.int32


def test_compressed_tree_psum_matches_reference():
    """1 and 4 ranks, 1 and 3 calls with the residual carried (a new
    gradient each call): the mean and every rank's residual bit for bit."""
    for n in (1, 4):
        for steps in (1, 3):
            check_psum(n, steps)


def check_psum(n, steps):
    rng = np.random.default_rng(10 * n + steps)
    grads = [ranks_tree(rng, n) for _ in range(steps)]
    ref_err = jax.vmap(RC.init_error_state)(jax.tree.map(jnp.asarray, grads[0]))
    port_err = [PC.init_error_state(t) for t in port_trees(grads[0], n)]
    for step, g in enumerate(grads):
        ref_mean, ref_err = REFERENCE(jax.tree.map(jnp.asarray, g), ref_err)
        mean, port_err = PC.compressed_tree_psum(port_trees(g, n), port_err)
        for path, exp in jax.tree_util.tree_flatten_with_path(ref_mean)[0]:
            key = [k.key for k in path]
            got = mean
            for k in key:
                got = got[k]
            assert_bitwise(got, np.asarray(exp)[0], (n, step, key, "mean"))  # every rank holds the mean
            for r in range(n):
                got_e = port_err[r]
                for k in key:
                    got_e = got_e[k]
                exp_e = ref_err
                for k in key:
                    exp_e = exp_e[k]
                assert_bitwise(got_e, np.asarray(exp_e)[r], (n, step, key, "residual", r))
    # An int leaf is the floor of its mean (negative sums included) and keeps its residual.
    total = sum(torch.as_tensor(np.asarray(grads[-1]["count"])[r]) for r in range(n))
    assert torch.equal(mean["count"], torch.div(total, n, rounding_mode="floor"))


def test_error_feedback_converges():
    """tests/test_fault_tolerance.py's check at 1 and 4 ranks: 64 calls on a
    constant fp32 gradient average to it at atol 1e-3, as the reference's do,
    every mean equal to the reference's."""
    for n in (1, 4):
        check_convergence(n)


def check_convergence(n):
    g = np.asarray([0.001, -1.0, 0.5, 0.3333], np.float32)
    trees = [{"g": torch.from_numpy(g.copy())} for _ in range(n)]
    err = [PC.init_error_state(t) for t in trees]
    ref_tree = {"g": jnp.broadcast_to(jnp.asarray(g), (n, 4))}
    ref_err = jax.vmap(RC.init_error_state)(ref_tree)
    acc, ref_acc = np.zeros(4, np.float32), np.zeros(4, np.float32)
    for _ in range(64):
        mean, err = PC.compressed_tree_psum(trees, err)
        ref_mean, ref_err = REFERENCE(ref_tree, ref_err)
        acc += mean["g"].numpy()
        ref_acc += np.asarray(ref_mean["g"])[0]
        np.testing.assert_array_equal(mean["g"].numpy(), np.asarray(ref_mean["g"])[0])
    np.testing.assert_allclose(acc / 64, g, atol=1e-3)
    np.testing.assert_array_equal(acc, ref_acc)
