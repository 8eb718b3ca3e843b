"""Adapter files: the port's save/load against the JAX package's, on the CPU.

A tiny Flux LoRA module of the port, with seeded adapters on every targeted
projection (the fused single-block ``linear1`` among them), is saved by the
port, loaded by the JAX package, saved again by the JAX package and loaded
back by the port: every adapter tensor must come back bitwise, in the
diffusers and the ComfyUI layouts.  The files of both packages hold the same
keys and values.
"""

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load_file

from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.flux.model import Flux as JaxFlux
from simpletuner_tpu.training.lora import flatten_lora
from simpletuner_tpu.training.lora import load_lora_safetensors as jax_load_lora
from simpletuner_tpu.training.lora import save_lora_safetensors as jax_save_lora

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models.flux import Flux
from simpletuner_tpu_torch.models.layers import init_parameters, lora_parameters
from simpletuner_tpu_torch.models.weight_bridge import lora_to_flax
from simpletuner_tpu_torch.models.weight_import import load_safetensors_file, save_safetensors
from simpletuner_tpu_torch.training.lora import load_lora_safetensors, lora_state_dict, save_lora_safetensors


def _models(target="all"):
    values = {"model_family": "flux", "model_arch_preset": "tiny", "model_type": "lora", "lora_rank": 4,
              "lora_alpha": 8, "flux_lora_target": target}
    previous = jl._LORA_TARGET
    try:
        jmodel = JaxFlux(config_namespace(values))
    finally:
        jl.set_lora_target(previous)
    return jmodel, Flux(config_namespace(values))


def _module(model, seed):
    module = init_parameters(model.create_module(), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for param in lora_parameters(module).values():
            param.copy_(torch.from_numpy(rng.standard_normal(tuple(param.shape)).astype(np.float32)))
    return module


def _lora_tensors(module):
    return {k: v.detach().clone() for k, v in lora_parameters(module).items()}


@pytest.mark.parametrize("target", ["all", "all+ffs"])
@pytest.mark.parametrize("fmt", ["diffusers", "comfyui"])
def test_adapters_round_trip_port_jax_port_bitwise(tmp_path, fmt, target):
    jmodel, model = _models(target)
    module = _module(model, seed=1)
    original = _lora_tensors(module)
    assert any("linear1" in k for k in original)  # the fused projection is in the round trip
    first, second = str(tmp_path / "port.safetensors"), str(tmp_path / "jax.safetensors")
    save_lora_safetensors(model, module, first, format=fmt)

    loaded = jax_load_lora(jmodel, first, lora_to_flax(_module(model, seed=9)))
    expected, got = flatten_lora(lora_to_flax(module)), flatten_lora(loaded)
    assert sorted(got) == sorted(expected)
    for path, leaves in expected.items():
        for leaf, array in leaves.items():
            assert np.array_equal(got[path][leaf], array), (path, leaf)
    jax_save_lora(jmodel, loaded, second, format=fmt)

    fresh = _module(model, seed=2)
    assert load_lora_safetensors(model, second, fresh) == []
    back = _lora_tensors(fresh)
    assert sorted(back) == sorted(original)
    assert all(torch.equal(back[k], original[k]) for k in original)


def test_port_file_holds_the_jax_files_keys_and_values(tmp_path):
    jmodel, model = _models()
    module = _module(model, seed=3)
    save_lora_safetensors(model, module, str(tmp_path / "port.safetensors"))
    jax_save_lora(jmodel, lora_to_flax(module), str(tmp_path / "jax.safetensors"))
    ours = load_safetensors_file(str(tmp_path / "port.safetensors"))
    theirs = np_load_file(str(tmp_path / "jax.safetensors"))
    assert sorted(ours) == sorted(theirs)
    assert all(np.array_equal(ours[k].numpy(), theirs[k]) for k in theirs)
    assert lora_state_dict(model, module)["transformer.single_transformer_blocks.0.attn.to_k.lora_B.weight"].shape == (64, 4)


def test_missing_adapters_keep_their_values_and_different_a_raises(tmp_path):
    _, model = _models()
    module = _module(model, seed=4)
    tensors = lora_state_dict(model, module)
    dropped = "transformer.transformer_blocks.0.attn.to_q"
    partial = {k: v for k, v in tensors.items() if not k.startswith(dropped + ".")}
    save_safetensors(partial, str(tmp_path / "partial.safetensors"))
    target = _module(model, seed=5)
    kept = _lora_tensors(target)
    assert load_lora_safetensors(model, str(tmp_path / "partial.safetensors"), target) == ["double_0/img_attn_q"]
    assert torch.equal(lora_parameters(target)["double_0/img_attn_q/lora_A"], kept["double_0/img_attn_q/lora_A"])

    split = dict(tensors)
    key = "transformer.single_transformer_blocks.0.attn.to_v.lora_A.weight"
    split[key] = split[key] + 1.0
    save_safetensors(split, str(tmp_path / "split.safetensors"))
    with pytest.raises(ValueError, match="different A"):
        load_lora_safetensors(model, str(tmp_path / "split.safetensors"), _module(model, seed=6))
