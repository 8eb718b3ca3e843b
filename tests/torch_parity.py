"""Helpers shared by the torch-port parity tests (tests/test_torch_*.py)."""

import jax
import numpy as np
import torch

from simpletuner_tpu_torch.models.weight_bridge import load_flax_params


def numpy_variables(flax_module, *args, seed=0, **kwargs):
    """Seeded numpy weights for every leaf of ``flax_module``'s variables.

    The tree comes from ``jax.eval_shape`` (no JAX init runs).  Kernels get
    N(0, 1/fan_in), norm scales 1 + N(0, 0.01), biases N(0, 0.01); nothing is
    zero, so AdaLN gates and LoRA ``B`` (zero at init in both frameworks) let
    attention and the adapter reach the output."""
    shapes = jax.eval_shape(lambda: flax_module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return fill_numpy(shapes, seed)


def fill_numpy(shapes, seed=0):
    """Seeded numpy leaves for a tree of shapes, by the rule of numpy_variables."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        draw = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * draw
        if name in ("kernel", "lora_A", "lora_B"):
            return draw / np.sqrt(np.prod(leaf.shape[:-1]))
        return 0.1 * draw

    return jax.tree_util.tree_map_with_path(fill, shapes)


def bridge(variables, port, ignore=()):
    """Load a numpy variables tree (a quantized base's ``qscales`` included)
    into a port module through the weight bridge."""
    return load_flax_params(port, variables["params"], variables.get("lora"), ignore=ignore,
                            qscales=variables.get("qscales"))


def rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def t(x):
    return torch.from_numpy(np.array(x))
