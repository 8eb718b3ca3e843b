"""The torch port's own host modules against the JAX package's, on the CPU.

The port imports nothing of ``simpletuner_tpu``: it keeps copies of the
framework-free modules it reads (the config-field registry, the config and
dataloader loaders, the local storage backend, the text-embed cache, the
Flux LoRA key map, the bucket math, the text-encoder specs).  These tests
hold each copy to its JAX counterpart on the same inputs, exactly, and check
in a fresh process that importing the whole port loads no module of the JAX
package, and that it imports with ``jax``, ``safetensors``, ``PIL`` and
``transformers`` refused (the caching tests hold the data and cache copies).
"""

import dataclasses
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from simpletuner_tpu.caching.text_embeds import TextEmbeddingCache as JaxTextEmbeddingCache
from simpletuner_tpu.configuration.dataloader import load_dataloader_config as jax_load_dataloader_config
from simpletuner_tpu.configuration.fields import REGISTRY as JAX_REGISTRY
from simpletuner_tpu.configuration.loader import load_config as jax_load_config
from simpletuner_tpu.data.backends.local import LocalDataBackend as JaxLocalDataBackend
from simpletuner_tpu.models.flux.transformer import FluxConfig as JaxFluxConfig
from simpletuner_tpu.training.lora import flux_key_map as jax_flux_key_map

import simpletuner_tpu_torch
from simpletuner_tpu_torch.caching.text_embeds import TextEmbeddingCache
from simpletuner_tpu_torch.configuration import REGISTRY, load_config, load_dataloader_config
from simpletuner_tpu_torch.data.backends.local import LocalDataBackend
from simpletuner_tpu_torch.models.flux import FluxConfig
from simpletuner_tpu_torch.training.lora import flux_key_map

REPO = Path(__file__).resolve().parents[1]

# a meta-path finder that refuses the JAX package, JAX itself and the
# libraries the port reads and writes its files without (safetensors, PIL,
# transformers), then every module of the port and every import statement of
# chip_smoke.py (module level and inside its functions); prints the JAX
# package's modules that got loaded
_ISOLATION_SCRIPT = r"""
import ast, importlib, importlib.abc, pkgutil, sys

REFUSED = ("simpletuner_tpu", "jax", "jaxlib", "flax", "safetensors", "PIL", "transformers")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
import simpletuner_tpu_torch
names = [m.name for m in pkgutil.walk_packages(simpletuner_tpu_torch.__path__, "simpletuner_tpu_torch.")]
for name in names:
    importlib.import_module(name)
tree = ast.parse(open("chip_smoke.py").read())
for node in ast.walk(tree):
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        exec(compile(ast.Module(body=[node], type_ignores=[]), "chip_smoke.py", "exec"), {})
print(len(names), sorted(m for m in sys.modules if m == "simpletuner_tpu" or m.startswith("simpletuner_tpu.")))
"""


def test_the_port_imports_nothing_of_the_jax_package():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    result = subprocess.run([sys.executable, "-c", _ISOLATION_SCRIPT], cwd=REPO, env=env, capture_output=True,
                            text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-3000:]
    count, loaded = result.stdout.strip().splitlines()[-1].split(" ", 1)
    n_modules = len(list(pkgutil.walk_packages(simpletuner_tpu_torch.__path__, "simpletuner_tpu_torch.")))
    assert int(count) == n_modules and loaded == "[]"


def test_registry_defaults_match():
    assert REGISTRY.defaults() == JAX_REGISTRY.defaults()


def test_registry_fields_match():
    def describe(registry):
        return [(f.name, f.type.value, f.default, tuple(f.choices or ()), f.section, f.aliases, f.help)
                for f in registry.fields()]

    assert describe(REGISTRY) == describe(JAX_REGISTRY)
    for alias in ("lr", "model", "flux_lora_target", "--resolution"):
        assert REGISTRY.resolve_name(alias.lstrip("-")) == JAX_REGISTRY.resolve_name(alias.lstrip("-"))


_CONFIG = {
    "--model_family": "flux", "model_type": "lora", "--lora_rank": "16", "learning_rate": "1e-4",
    "train_batch_size": 2, "resolution": "1024", "mixed_precision": "bf16", "validation_seed": "42",
    "flux_attention_masked_training": "true", "use_ema": False, "optimizer": "adamw_bf16",
    "validation_prompt": "a lighthouse, at dusk", "data_backend_config": [{"id": "x"}],
}


def _write_config(tmp_path, fmt):
    if fmt == "json":
        path = tmp_path / "config.json"
        path.write_text(json.dumps(_CONFIG))
    elif fmt == "toml":
        path = tmp_path / "config.toml"
        path.write_text("\n".join(f'{k.lstrip("-")} = {json.dumps(v)}' for k, v in _CONFIG.items()
                                  if not isinstance(v, list)))
    else:
        path = tmp_path / "config.env"
        lines = [f"{k.lstrip('-').upper()}={v}" for k, v in _CONFIG.items() if isinstance(v, (str, int))
                 and not isinstance(v, bool) and k.lstrip("-") != "validation_prompt"]
        lines.append('TRAINER_EXTRA_ARGS="--validation_prompt=a lighthouse --use_ema"')
        path.write_text("\n".join(lines))
    return path


@pytest.mark.parametrize("fmt", ["json", "toml", "env"])
def test_load_config_matches(tmp_path, monkeypatch, fmt):
    monkeypatch.setenv("SIMPLETUNER_CONFIG_SEED", "7")
    monkeypatch.setenv("SIMPLETUNER_CONFIG_LR", "3e-4")
    path = _write_config(tmp_path, fmt)
    overrides = {"--max_train_steps": "10", "lr_scheduler": "cosine"}
    ours = load_config(config_path=str(path), overrides=overrides)
    theirs = jax_load_config(config_path=str(path), overrides=overrides)
    assert ours == theirs
    assert ours["seed"] == 7 and ours["max_train_steps"] == 10


_DATASETS = [
    {"id": "pseudo-camera", "type": "local", "instance_data_dir": "/data/a", "crop": True,
     "crop_style": "center", "crop_aspect": "square", "resolution": 1.0, "resolution_type": "area",
     "caption_strategy": "textfile", "cache_dir_vae": "cache/vae/a", "repeats": 3},
    {"id": "conditioning", "type": "local", "dataset_type": "conditioning", "instance_data_dir": "/data/c",
     "caption_strategy": "filename"},
    {"id": "disabled-set", "type": "local", "disabled": True, "instance_data_dir": "/data/d"},
    {"id": "embeds", "dataset_type": "text_embeds", "type": "local", "default": True, "cache_dir": "cache/text"},
]


def test_load_dataloader_config_matches(tmp_path):
    path = tmp_path / "multidatabackend.json"
    path.write_text(json.dumps(_DATASETS))
    defaults = {"resolution": 1024, "resolution_type": "pixel_area", "caption_strategy": "filename"}
    for source in (str(path), _DATASETS):
        ours = [dataclasses.asdict(d) for d in load_dataloader_config(source, global_defaults=defaults)]
        theirs = [dataclasses.asdict(d) for d in jax_load_dataloader_config(source, global_defaults=defaults)]
        assert ours == theirs and sorted(d["id"] for d in ours) == ["conditioning", "embeds", "pseudo-camera"]


def _embeds(seed):
    rng = np.random.default_rng(seed)
    return {"t5_embeds": rng.standard_normal((512, 64), dtype=np.float32),
            "pooled_embeds": rng.standard_normal(32, dtype=np.float32),
            "attention_mask": (np.arange(512) < 77).astype(np.int64)}


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_text_embed_cache_round_trips(tmp_path, compress, writer):
    caches = {
        "jax": JaxTextEmbeddingCache("embeds", JaxLocalDataBackend("embeds", compress_cache=compress),
                                     str(tmp_path), "flux"),
        "port": TextEmbeddingCache("embeds", LocalDataBackend("embeds", compress_cache=compress),
                                   str(tmp_path), "flux"),
    }
    reader = "port" if writer == "jax" else "jax"
    prompt, embeds = "a lighthouse on a basalt cliff", _embeds(0)
    caches[writer].save(prompt, embeds)
    assert caches[reader].cache_path(prompt) == caches[writer].cache_path(prompt)
    assert caches[reader].exists(prompt) and not caches[reader].exists("another prompt")
    loaded = caches[reader].load(prompt)
    assert sorted(loaded) == sorted(embeds)
    for key, value in embeds.items():
        assert loaded[key].dtype == value.dtype and np.array_equal(loaded[key], value)
    # a bf16 tensor written by either side loads as f32 on the other
    caches[writer].save("bf16", {"t5_embeds": torch.ones(3, 2, dtype=torch.bfloat16)})
    assert caches[reader].load("bf16")["t5_embeds"].dtype == np.float32


@pytest.mark.parametrize("preset", ["tiny", "full"])
def test_flux_lora_key_map_matches(preset):
    jax_arch = JaxFluxConfig.tiny() if preset == "tiny" else JaxFluxConfig()
    arch = FluxConfig.tiny() if preset == "tiny" else FluxConfig()
    assert (arch.hidden_size, arch.depth_double, arch.depth_single, arch.mlp_ratio) == (
        jax_arch.hidden_size, jax_arch.depth_double, jax_arch.depth_single, jax_arch.mlp_ratio)
    assert flux_key_map(arch) == jax_flux_key_map(jax_arch)


def test_validation_defaults_to_the_card():
    import inspect

    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.flux import Flux
    from simpletuner_tpu_torch.training.validation import Validation

    assert inspect.signature(Validation).parameters["device"].default == "cuda"
    config = config_namespace({"model_family": "flux", "model_arch_preset": "tiny", "validation_resolution": 64})
    model = Flux(config, FluxConfig.tiny())
    if torch.cuda.is_available():
        assert Validation(model, config).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            Validation(model, config)
    assert Validation(model, config, device="cpu").device.type == "cpu"


def test_text_encoder_specs_match():
    from simpletuner_tpu.models.flux.model import Flux as JaxFlux

    from simpletuner_tpu_torch.models.flux import Flux

    ours = [dataclasses.asdict(s) for s in Flux.TEXT_ENCODER_CONFIGURATION]
    theirs = [dataclasses.asdict(s) for s in JaxFlux.TEXT_ENCODER_CONFIGURATION]
    assert ours == theirs
    assert (Flux.LATENT_CHANNEL_COUNT, Flux.MODEL_TYPE) == (JaxFlux.LATENT_CHANNEL_COUNT, JaxFlux.MODEL_TYPE)
