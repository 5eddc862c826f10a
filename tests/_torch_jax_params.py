"""Flax param trees for the port's parity tests, without running Flax's init.

Flax initialises a module op by op, and the JAX tiny models' inits took a
large share of the port's CPU test time. Here the init is only traced
(`jax.eval_shape`) for the tree's structure and shapes, and the values come
from numpy's seeded stream by the fan-in rule of
`invertible_cd_tpu_torch.models.layers.fan_in_init_`; both packages then get
the same weights.
"""
import jax
import jax.numpy as jnp
import numpy as np


def traced_init(module, *args):
    """The abstract tree `module.init(PRNGKey(0), *args)` returns, traced only."""
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))


def seeded_params(tree, seed=0):
    """Concrete weights for a tree of abstract arrays: kernels N(0, 1/fan_in)
    (fan_in = the product of all but the output axis), embeddings N(0, 1/4),
    norm scales 1 + 0.05 N, BatchNorm variances (`var`) 1 + 0.05 |N| (a
    variance must be positive), biases and other leaves 0.05 N. Every leaf
    takes one draw of its shape, in tree order."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        noise = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return jnp.asarray(noise / np.sqrt(np.prod(s.shape[:-1])))
        if name in ("embedding", "position_embedding"):
            return jnp.asarray(noise * 0.5)
        if name == "var":
            return jnp.asarray(1.0 + 0.05 * np.abs(noise))
        return jnp.asarray(1.0 + 0.05 * noise if name == "scale" else 0.05 * noise)
    return jax.tree_util.tree_map_with_path(draw, tree)
