"""The torch port's own host modules against the JAX package's, on the CPU.

The port imports nothing of ``simpletuner_tpu``: it keeps copies of the
framework-free modules it reads (the config-field registry, the config and
dataloader loaders, ``TrainingConfig``, the local storage backend, the
text-embed cache, the Flux LoRA key map, the bucket math, the text-encoder
specs, and for the trainer runtime the webhooks, the iteration tracker, the
JSONL tracker, ``DiskGuard``, captions, the sampler, the batch fetcher, the
bucket report and the modelspec / model card; for the entry points the
OPTIONS.md generator and the model registry).  These tests
hold each copy to its JAX counterpart on the same inputs, exactly, and check
in a fresh process that importing the whole port loads no module of the JAX
package, and that it imports with ``jax``, ``safetensors``, ``PIL``,
``transformers`` and ``cv2`` refused (the caching tests hold the data and
cache copies; ``tests/test_torch_video.py`` the video copies).
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
# transformers; OpenCV, which reads and writes clips), then every module of the port and every import statement of
# chip_smoke.py (module level and inside its functions); prints the JAX
# package's modules that got loaded
_ISOLATION_SCRIPT = r"""
import ast, importlib, importlib.abc, pkgutil, sys

REFUSED = ("simpletuner_tpu", "jax", "jaxlib", "flax", "safetensors", "PIL", "transformers", "cv2")

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
    names = [m.name for m in pkgutil.walk_packages(simpletuner_tpu_torch.__path__, "simpletuner_tpu_torch.")]
    assert int(count) == len(names) and loaded == "[]"
    # the SDXL slice's modules, the SD 1.x / 2.x, PixArt-Sigma, AuraFlow, Wan, LTX-Video, Chroma, Lumina2,
    # decoder-LLM, Kandinsky 5.0, HunyuanVideo, Qwen-Image, MageFlow / Z-Image, HiDream, FLUX.2, Kolors,
    # LongCat-Image, Z-Image-Omni, Zlab-i1, Boogu-Image, Krea-2, Cosmos and Anima ones (with the EDM Euler
    # scheduler), the OmniGen, ERNIE-Image and Ideogram ones (with Ideogram's host prompt modules), and the
    # LongCat-Video, Sana and Sana-Video ones, Cosmos3's (the MoT, the family, the reasoner and the AVAE
    # audio tokenizer), LTX-2's (the DiT, the family, the connectors and the latent upsampler) and the audio
    # modality's (the data copy, the audio VAE and ACE-Step's DiT, family and lyric tokenizer) are among
    # those imported
    assert {f"simpletuner_tpu_torch.{name}" for name in (
        "models.unet", "models.sdxl", "models.sdxl.model", "schedulers.ddim", "schedulers.unipc", "models.sd1x",
        "models.sd1x.model", "models.pixart", "models.pixart.model", "models.pixart.transformer",
        "models.auraflow", "models.auraflow.model", "models.auraflow.transformer", "models.wan", "models.wan.model",
        "models.wan.transformer", "models.video_vae", "data.video", "models.ltxvideo", "models.ltxvideo.model",
        "models.ltxvideo.transformer", "models.chroma", "models.chroma.model", "models.chroma.transformer",
        "models.lumina2", "models.lumina2.model", "models.lumina2.transformer", "models.llm_encoder",
        "models.kandinsky5", "models.kandinsky5.model", "models.kandinsky5.transformer", "models.hunyuanvideo",
        "models.hunyuanvideo.model", "models.hunyuanvideo.transformer", "models.qwen_image",
        "models.qwen_image.model", "models.qwen_image.transformer", "models.mageflow", "models.mageflow.model",
        "models.hidream", "models.hidream.model", "models.hidream.transformer", "models.flux2", "models.flux2.model",
        "models.flux2.transformer", "models.kolors", "models.kolors.model", "models.longcat_image",
        "models.longcat_image.model", "models.z_image_omni", "models.z_image_omni.model",
        "models.z_image_omni.transformer", "models.zlab_i1", "models.zlab_i1.model", "models.zlab_i1.transformer",
        "models.zlab_i1.latent_utils", "models.extended", "models.extended.model", "models.krea2",
        "models.krea2.model", "models.krea2.transformer", "models.cosmos1", "models.cosmos1.transformer",
        "models.cosmos2", "models.cosmos2.model", "models.anima", "models.anima.model", "models.anima.transformer",
        "schedulers.edm_euler", "models.omnigen", "models.omnigen.model", "models.omnigen.transformer",
        "models.ernie", "models.ernie.model", "models.ernie.transformer", "models.ideogram", "models.ideogram.model",
        "models.ideogram.transformer", "models.ideogram.prompting", "models.ideogram.prompt_enhancer",
        "models.longcat_video", "models.longcat_video.model", "models.longcat_video.transformer", "models.sana",
        "models.sana.model", "models.sana.transformer", "models.sanavideo", "models.sanavideo.model",
        "models.sanavideo.transformer", "models.cosmos3", "models.cosmos3.model", "models.cosmos3.transformer",
        "models.cosmos3.reasoner", "models.cosmos3.audio_tokenizer", "models.ltxvideo2", "models.ltxvideo2.model",
        "models.ltxvideo2.transformer", "models.ltxvideo2.connectors", "models.ltxvideo2.latent_upsampler",
        "data.audio", "models.audio_vae", "models.ace_step", "models.ace_step.model", "models.ace_step.transformer",
        "models.ace_step.lyrics")} <= set(names)


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


@pytest.mark.parametrize("preset", ["tiny", "medium", "large"])
def test_sd3_lora_key_map_matches(preset):
    from simpletuner_tpu.models.sd3 import SD3Config as JaxSD3Config
    from simpletuner_tpu.training.lora import sd3_key_map as jax_sd3_key_map

    from simpletuner_tpu_torch.models.sd3 import SD3Config
    from simpletuner_tpu_torch.training.lora import sd3_key_map

    jax_arch, arch = getattr(JaxSD3Config, preset)(), getattr(SD3Config, preset)()
    assert dataclasses.asdict(arch) == dataclasses.asdict(jax_arch)
    assert sd3_key_map(arch) == jax_sd3_key_map(jax_arch)


def test_sd3_family_matches():
    """The SD3 family's static contract: flavours and their configs, the three
    encoder specs (T5 at 256 tokens, no tokenizer subfolders), the VAE
    factors, the LoRA target names, the acceleration presets (the port leaves
    out the mesh preset, ROADMAP Queue 1 item 5)."""
    from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
    from simpletuner_tpu.models.sd3 import SD3 as JaxSD3

    from simpletuner_tpu_torch.configuration import TrainingConfig
    from simpletuner_tpu_torch.models.sd3 import SD3

    for name in ("NAME", "PREDICTION_TYPE", "MODEL_TYPE", "LATENT_CHANNEL_COUNT", "DEFAULT_RESOLUTION",
                 "DEFAULT_FLAVOUR", "HUGGINGFACE_PATHS", "DEFAULT_LORA_TARGET", "VAE_SCALING_FACTOR",
                 "VAE_SHIFT_FACTOR"):
        assert getattr(SD3, name) == getattr(JaxSD3, name), name
    assert [dataclasses.asdict(s) for s in SD3.TEXT_ENCODER_CONFIGURATION] == \
        [dataclasses.asdict(s) for s in JaxSD3.TEXT_ENCODER_CONFIGURATION]
    for values in ({}, {"model_flavour": "large-3.5"}, {"model_flavour": "medium-3.0"},
                   {"model_arch_preset": "tiny"}):
        values = {"model_family": "sd3", **values}
        ours, theirs = SD3(TrainingConfig(values)), JaxSD3(JaxTrainingConfig(values))
        assert dataclasses.asdict(ours.arch) == dataclasses.asdict(theirs.arch)
        assert ours.latent_channels == theirs.latent_channels and ours.huggingface_path() == theirs.huggingface_path()
        assert {k: tuple(v.shape) for k, v in ours.example_batch(2, 128).items()} == \
            {k: tuple(v.shape) for k, v in theirs.example_batch(2, 128).items()}
    jax_presets = [p for p in JaxSD3.get_acceleration_presets() if p["name"] != "multichip"]
    assert [(p["name"], p["config"]) for p in SD3.get_acceleration_presets()] == \
        [(p["name"], p["config"]) for p in jax_presets]
    with pytest.raises(ValueError, match="flow-matching"):
        SD3(TrainingConfig({"model_family": "sd3", "prediction_type": "epsilon"})).check_user_config()


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


# ---- the trainer runtime's host copies -----------------------------------------------------


def _without_time(event):
    return {k: v for k, v in event.items() if k not in ("timestamp", "time")}


def test_webhook_events_and_handler_match():
    from simpletuner_tpu.webhooks import events as jax_events
    from simpletuner_tpu.webhooks.handler import WebhookHandler as JaxWebhookHandler

    from simpletuner_tpu_torch.webhooks import events
    from simpletuner_tpu_torch.webhooks.handler import WebhookHandler

    calls = [
        ("lifecycle_stage_event", ("train", "failed", "job", "boom"), {}),
        ("training_status_event", (4, 8, 1), {"loss": 0.5, "learning_rate": 1e-4, "iterations_per_second": 2.0,
                                               "eta_seconds": 2.0, "job_id": "j", "extra_metrics": {"a": 1}}),
        ("notification_event", ("hello", "warning", "j"), {}),
        ("error_event", ("failed", ValueError("x"), "j"), {}),
        ("checkpoint_event", ("/out/checkpoint-4", 4, True, "j"), {}),
        ("device_fault_event", ("oom", {"step": 3}, "j"), {}),
        ("validation_event", (8, "a cat", "/out/validation/step_8_0.png", "j"), {}),
    ]
    for name, args, kwargs in calls:
        assert _without_time(getattr(events, name)(*args, **kwargs)) == \
            _without_time(getattr(jax_events, name)(*args, **kwargs)), name
    # without a webhook configured neither handler queues anything
    for handler in (WebhookHandler(), JaxWebhookHandler()):
        assert not handler.enabled
        handler.send_raw(events.checkpoint_event("/x", 1))
        handler.send("message")
        assert handler._queue.empty() and handler._worker is None


def test_iteration_tracker_matches(monkeypatch):
    from simpletuner_tpu.training import iteration_tracker as jax_module

    from simpletuner_tpu_torch.training import iteration_tracker as module

    clock = iter(np.cumsum([0.0, 1.5, 0.5, 2.0, 400.0, 1.0, 0.25, 3.0] * 4).tolist())
    ticks = []

    def now():
        if not ticks:
            ticks.append(next(clock))
        return ticks[-1]

    monkeypatch.setattr(module.time, "monotonic", now)
    monkeypatch.setattr(jax_module.time, "monotonic", now)
    ours, theirs = module.IterationTracker(), jax_module.IterationTracker()
    for _ in range(8):
        ticks.clear()
        ours.record_step()
        theirs.record_step()
        assert ours.rates() == theirs.rates()
        assert ours.eta_seconds(10) == theirs.eta_seconds(10) and ours.rate(60) == theirs.rate(60)


def test_trackers_match(tmp_path):
    from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
    from simpletuner_tpu.training.trackers import build_trackers as jax_build_trackers

    from simpletuner_tpu_torch.configuration import TrainingConfig
    from simpletuner_tpu_torch.training.trackers import build_trackers

    values = {"report_to": "jsonl,unknown_tracker", "tracker_run_name": "run"}
    ours = build_trackers(TrainingConfig(values), str(tmp_path / "ours"))
    theirs = jax_build_trackers(JaxTrainingConfig(values), str(tmp_path / "theirs"))
    assert [t.name for t in ours] == [t.name for t in theirs] == ["jsonl"]
    for trackers in (ours, theirs):
        trackers[0].log({"loss": torch.tensor(0.25), "grad_norm": np.float32(1.5), "epoch": 2, "tag": "x"}, 3)
        trackers[0].finish()
    lines = [[_without_time(json.loads(line)) for line in open(d / "run-metrics.jsonl")]
             for d in (tmp_path / "ours", tmp_path / "theirs")]
    assert lines[0] == lines[1] == [{"step": 3, "loss": 0.25, "grad_norm": 1.5, "epoch": 2.0, "tag": "x"}]


def test_disk_guard_matches(tmp_path):
    from simpletuner_tpu.training.profiling import DiskGuard as JaxDiskGuard
    from simpletuner_tpu.training.profiling import parse_size_threshold as jax_parse

    from simpletuner_tpu_torch.training.profiling import DiskGuard, parse_size_threshold

    for raw in (None, "", "None", "100G", "50M", "1.5T", "500K", "1024", "2gb", 4096):
        assert parse_size_threshold(raw) == jax_parse(raw)
    with pytest.raises(ValueError):
        parse_size_threshold("lots")
    for config in ({"disk_low_threshold": "1K"}, {"disk_low_threshold": "1000T"}, {},
                   {"disk_space_threshold_gb": 1e9, "disk_space_action": "warn"},
                   {"disk_space_threshold_gb": 1e9, "disk_space_action": "stop"}):
        outcomes = []
        for guard_cls in (DiskGuard, JaxDiskGuard):
            guard = guard_cls(config, str(tmp_path / "missing" / "dir"))
            try:
                outcomes.append(guard.check_before_checkpoint())
            except RuntimeError as exc:
                outcomes.append(type(exc).__name__ + str(exc).split(":")[0])
        assert outcomes[0] == outcomes[1], config


def test_captions_match(tmp_path):
    from simpletuner_tpu.data.captions import get_caption as jax_get_caption

    from simpletuner_tpu_torch.data.captions import get_caption

    (tmp_path / "a_photo-of_cat.png").write_bytes(b"")
    (tmp_path / "with_text.png").write_bytes(b"")
    (tmp_path / "with_text.txt").write_text("  a red cat, sitting  \n")
    backend = LocalDataBackend("c", instance_data_dir=str(tmp_path))
    cases = [
        dict(strategy="filename"), dict(strategy="textfile"), dict(strategy="instanceprompt", instance_prompt="sks"),
        dict(strategy="textfile", instance_prompt="sks", prepend_instance_prompt=True),
        dict(strategy="textfile", caption_filters=["red ", "s/cat/dog/"]),
        dict(strategy="csv", metadata_row={"caption": ["first", "second"]}),
        dict(strategy="parquet", metadata_row={"text": "row caption"}, parquet_config={"caption_column": "text"}),
    ]
    for name in ("a_photo-of_cat.png", "with_text.png"):
        for kwargs in cases:
            path = str(tmp_path / name)
            assert get_caption(path, backend, **kwargs) == jax_get_caption(path, backend, **kwargs), kwargs


class _Buckets:
    """A metadata backend's bucket index, as the sampler and the report read it."""

    def __init__(self):
        self.id = "m"
        self.aspect_ratio_bucket_indices = {"1.0": [f"/d/s{i}.png" for i in range(5)],
                                            "0.75": [f"/d/p{i}.png" for i in range(3)],
                                            "1.33": ["/d/l0.png"]}
        self.image_metadata = {p: {"crop_coordinates": [i, 0]} for i, p in enumerate(
            sum(self.aspect_ratio_bucket_indices.values(), []))}
        self.image_metadata["/d/l0.png"]["skipped"] = "too small"

    def bucket_keys(self):
        return sorted(self.aspect_ratio_bucket_indices)


def test_sampler_matches():
    from simpletuner_tpu.data.sampler import MultiAspectSampler as JaxSampler

    from simpletuner_tpu_torch.data.sampler import MultiAspectSampler

    ours, theirs = MultiAspectSampler("m", _Buckets(), 2, seed=5, repeats=1), JaxSampler("m", _Buckets(), 2, 5,
                                                                                          repeats=1)
    assert len(ours) == len(theirs) > 0
    for epoch in range(3):
        batches = [list(ours), list(theirs)]
        assert batches[0] == batches[1] and batches[0], epoch
        assert ours.save_state() == theirs.save_state()
    # mid-epoch state round-trips through JSON on both sides
    it_ours, it_theirs = iter(ours), iter(theirs)
    assert next(it_ours) == next(it_theirs)
    state = json.loads(ours.state_json())
    assert state == json.loads(theirs.state_json())
    rest = list(it_ours)
    fresh_ours, fresh_theirs = MultiAspectSampler("m", _Buckets(), 2, seed=5, repeats=1), JaxSampler(
        "m", _Buckets(), 2, 5, repeats=1)
    fresh_ours.load_state(state)
    fresh_theirs.load_state(state)
    assert list(fresh_ours) == list(fresh_theirs) == rest


def test_batch_fetcher_matches():
    from simpletuner_tpu.data.batch_fetcher import BatchFetcher as JaxBatchFetcher

    from simpletuner_tpu_torch.data.batch_fetcher import BatchFetcher

    class Counting:
        def __init__(self):
            self.cursor, self.epoch = 0, 0

        def next_batch(self, step=0):
            self.cursor += 1
            self.epoch = self.cursor // 3
            return {"latents": np.full((1,), step, np.float32), "cursor": self.cursor}

        def save_state(self):
            return {"cursor": self.cursor}

    seqs = []
    for fetcher_cls in (BatchFetcher, JaxBatchFetcher):
        fetcher = fetcher_cls(Counting(), start_step=5, depth=3)
        seqs.append([(raw["cursor"], float(raw["latents"][0]), epoch, state)
                     for raw, epoch, state in (fetcher.next_batch() for _ in range(7))])
        fetcher.stop()
    assert seqs[0] == seqs[1] and seqs[0][0] == (1, 5.0, 0, {"cursor": 1})


def test_bucket_report_matches():
    from simpletuner_tpu.data.bucket_report import bucket_report as jax_bucket_report
    from simpletuner_tpu.data.bucket_report import format_report as jax_format_report

    from simpletuner_tpu_torch.data.bucket_report import bucket_report, format_report

    assert bucket_report(_Buckets()) == jax_bucket_report(_Buckets())
    assert format_report(bucket_report(_Buckets())) == jax_format_report(jax_bucket_report(_Buckets()))


def test_modelspec_and_model_card_match():
    from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
    from simpletuner_tpu.models.flux.model import Flux as JaxFlux
    from simpletuner_tpu.publishing.metadata import build_model_card as jax_build_model_card
    from simpletuner_tpu.publishing.metadata import safetensors_modelspec as jax_modelspec

    from simpletuner_tpu_torch.configuration import TrainingConfig
    from simpletuner_tpu_torch.models.flux import Flux
    from simpletuner_tpu_torch.publishing.metadata import build_model_card, safetensors_modelspec

    values = {"model_family": "flux", "model_arch_preset": "tiny", "resolution": 512, "instance_prompt": "sks",
              "modelspec_trigger_words": "ohwx, dog", "modelspec_comment": "note", "lora_rank": 4,
              "base_model_precision": "int8-quanto", "model_card_note": "hello"}
    ours, theirs = Flux(TrainingConfig(values)), JaxFlux(JaxTrainingConfig(values))
    kwargs = dict(trigger_words=["cat"], tag_frequency={"a": {"red": 2}})
    spec, jax_spec = safetensors_modelspec(ours, ours.config, **kwargs), jax_modelspec(theirs, theirs.config, **kwargs)
    assert {k: v for k, v in spec.items() if k != "modelspec.date"} == \
        {k: v for k, v in jax_spec.items() if k != "modelspec.date"}
    card = dict(validation_prompts=["a", "b"], validation_images=["v.png"], train_steps=8)
    assert build_model_card(ours, ours.config, **card) == jax_build_model_card(theirs, theirs.config, **card)


def test_training_config_matches(tmp_path):
    from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig

    from simpletuner_tpu_torch.configuration import TrainingConfig

    path = _write_config(tmp_path, "json")
    argv = ["--config", str(path), "--max_train_steps", "12", "--use_ema", "true", "--custom_key", "v",
            "--flag_only"]
    ours, theirs = TrainingConfig.from_cli(argv), JaxTrainingConfig.from_cli(argv)
    assert ours.to_dict() == theirs.to_dict() and ours.lora_alpha == 16
    assert ours.was_provided("max_train_steps") and not ours.was_provided("seed")


def test_model_arch_overrides_lay_fields_over_the_arch():
    """``model_arch_overrides`` (a mapping or its JSON) replaces fields of the
    arch the family chose, preset included; a field the arch lacks raises."""
    from simpletuner_tpu_torch.configuration import TrainingConfig
    from simpletuner_tpu_torch.models.flux import FluxConfig
    from simpletuner_tpu_torch.models.registry import get_model_family

    tiny = get_model_family(TrainingConfig({"model_family": "flux", "model_arch_preset": "tiny",
                                            "model_arch_overrides": {"depth_double": 1, "depth_single": 3}}))
    assert tiny.arch == dataclasses.replace(FluxConfig.tiny(), depth_double=1, depth_single=3)
    full = get_model_family(TrainingConfig({"model_family": "flux",
                                            "model_arch_overrides": '{"depth_double": 2, "depth_single": 4}'}))
    assert (full.arch.depth_double, full.arch.depth_single, full.arch.hidden_size) == (2, 4, 3072)
    assert get_model_family(TrainingConfig({"model_family": "flux"})).arch.depth_double == 19
    with pytest.raises(ValueError, match=r"no arch field \['depth'\]"):
        get_model_family(TrainingConfig({"model_family": "flux", "model_arch_overrides": {"depth": 2}}))


def test_model_registry_refuses_other_families():
    from simpletuner_tpu_torch.configuration import TrainingConfig
    from simpletuner_tpu_torch.models.flux import Flux
    from simpletuner_tpu_torch.models.registry import get_model_family

    from simpletuner_tpu_torch.models.sd3 import SD3

    assert isinstance(get_model_family(TrainingConfig({"model_family": "flux"})), Flux)
    assert isinstance(get_model_family(TrainingConfig({"model_family": "sd3"})), SD3)
    with pytest.raises(ValueError, match="flow-matching"):  # check_user_config runs, as in the JAX registry
        get_model_family(TrainingConfig({"model_family": "sd3", "prediction_type": "epsilon"}))
    from simpletuner_tpu_torch.models.sdxl import SDXL

    assert isinstance(get_model_family(TrainingConfig({"model_family": "sdxl"})), SDXL)
    with pytest.raises(ValueError, match="epsilon"):
        get_model_family(TrainingConfig({"model_family": "sdxl", "prediction_type": "flow_matching"}))
    from simpletuner_tpu_torch.models.auraflow import AuraFlow

    assert isinstance(get_model_family(TrainingConfig({"model_family": "auraflow"})), AuraFlow)
    from simpletuner_tpu_torch.models.wan import Wan

    assert isinstance(get_model_family(TrainingConfig({"model_family": "wan"})), Wan)
    from simpletuner_tpu_torch.models.ltxvideo import LTXVideo

    assert isinstance(get_model_family(TrainingConfig({"model_family": "ltxvideo"})), LTXVideo)
    from simpletuner_tpu_torch.models.chroma import Chroma
    from simpletuner_tpu_torch.models.lumina2 import Lumina2

    assert isinstance(get_model_family(TrainingConfig({"model_family": "chroma"})), Chroma)
    assert isinstance(get_model_family(TrainingConfig({"model_family": "lumina2"})), Lumina2)
    from simpletuner_tpu_torch.models.hunyuanvideo import HunyuanVideo
    from simpletuner_tpu_torch.models.kandinsky5 import Kandinsky5Image, Kandinsky5Video

    assert isinstance(get_model_family(TrainingConfig({"model_family": "hunyuanvideo"})), HunyuanVideo)
    assert isinstance(get_model_family(TrainingConfig({"model_family": "kandinsky5_video"})), Kandinsky5Video)
    assert isinstance(get_model_family(TrainingConfig({"model_family": "kandinsky5-image"})), Kandinsky5Image)
    from simpletuner_tpu_torch.models.hidream import HiDream
    from simpletuner_tpu_torch.models.mageflow import MageFlow, ZImage
    from simpletuner_tpu_torch.models.qwen_image import QwenImage

    assert isinstance(get_model_family(TrainingConfig({"model_family": "qwen_image"})), QwenImage)
    assert isinstance(get_model_family(TrainingConfig({"model_family": "z_image"})), ZImage)
    assert type(get_model_family(TrainingConfig({"model_family": "mageflow"}))) is MageFlow
    assert isinstance(get_model_family(TrainingConfig({"model_family": "hidream"})), HiDream)
    from simpletuner_tpu_torch.models.flux2 import Flux2
    from simpletuner_tpu_torch.models.kolors import Kolors

    assert isinstance(get_model_family(TrainingConfig({"model_family": "flux2"})), Flux2)
    assert isinstance(get_model_family(TrainingConfig({"model_family": "kolors"})), Kolors)
    from simpletuner_tpu_torch.models.extended import BooguImage
    from simpletuner_tpu_torch.models.longcat_image import LongcatImage
    from simpletuner_tpu_torch.models.z_image_omni import ZImageOmni
    from simpletuner_tpu_torch.models.zlab_i1 import ZlabI1

    assert isinstance(get_model_family(TrainingConfig({"model_family": "longcat_image"})), LongcatImage)
    assert isinstance(get_model_family(TrainingConfig({"model_family": "z_image_omni"})), ZImageOmni)
    assert isinstance(get_model_family(TrainingConfig({"model_family": "zlab_i1"})), ZlabI1)
    assert isinstance(get_model_family(TrainingConfig({"model_family": "boogu_image"})), BooguImage)
    from simpletuner_tpu_torch.models.anima import Anima
    from simpletuner_tpu_torch.models.cosmos2 import Cosmos2Image
    from simpletuner_tpu_torch.models.krea2 import Krea2

    assert isinstance(get_model_family(TrainingConfig({"model_family": "krea2"})), Krea2)
    assert isinstance(get_model_family(TrainingConfig({"model_family": "cosmos"})), Cosmos2Image)
    assert isinstance(get_model_family(TrainingConfig({"model_family": "anima"})), Anima)
    from simpletuner_tpu_torch.models.ernie import Ernie
    from simpletuner_tpu_torch.models.ideogram import Ideogram
    from simpletuner_tpu_torch.models.omnigen import OmniGen

    assert isinstance(get_model_family(TrainingConfig({"model_family": "omnigen"})), OmniGen)
    assert isinstance(get_model_family(TrainingConfig({"model_family": "ernie"})), Ernie)
    assert isinstance(get_model_family(TrainingConfig({"model_family": "ideogram"})), Ideogram)
    from simpletuner_tpu_torch.models.longcat_video import LongcatVideo
    from simpletuner_tpu_torch.models.sana import Sana
    from simpletuner_tpu_torch.models.sanavideo import SanaVideo

    assert isinstance(get_model_family(TrainingConfig({"model_family": "longcat_video"})), LongcatVideo)
    assert isinstance(get_model_family(TrainingConfig({"model_family": "sana"})), Sana)
    assert isinstance(get_model_family(TrainingConfig({"model_family": "sanavideo"})), SanaVideo)
    from simpletuner_tpu_torch.models.cosmos3 import Cosmos3

    assert isinstance(get_model_family(TrainingConfig({"model_family": "cosmos3"})), Cosmos3)
    from simpletuner_tpu_torch.models.ltxvideo2 import LTXVideo2

    assert isinstance(get_model_family(TrainingConfig({"model_family": "ltxvideo2"})), LTXVideo2)
    from simpletuner_tpu_torch.models.ace_step import ACEStep
    from simpletuner_tpu_torch.models.extended import WanS2V

    assert isinstance(get_model_family(TrainingConfig({"model_family": "ace_step"})), ACEStep)
    assert isinstance(get_model_family(TrainingConfig({"model_family": "wan_s2v"})), WanS2V)
    for family in ("heartmula", "deepfloyd", "stable_cascade"):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 6"):
            get_model_family(TrainingConfig({"model_family": family}))
    with pytest.raises(KeyError):
        get_model_family(TrainingConfig({"model_family": "nope"}))


def test_doc_generator_matches():
    from simpletuner_tpu.configuration.doc_generator import generate_options_markdown as jax_markdown

    from simpletuner_tpu_torch.configuration.doc_generator import generate_options_markdown

    assert generate_options_markdown() == jax_markdown()


def test_model_registry_matches():
    from simpletuner_tpu.models.registry import ModelRegistry as JaxModelRegistry

    from simpletuner_tpu_torch.models.flux import Flux
    from simpletuner_tpu_torch.models.registry import ModelRegistry

    assert ModelRegistry.families() == JaxModelRegistry.families()
    for name in ModelRegistry.families() + ["sd15", "pixart", "ltx2", "kandinsky5-image"]:
        assert ModelRegistry.metadata(name) == JaxModelRegistry.metadata(name), name
    from simpletuner_tpu_torch.models.sd3 import SD3

    assert ModelRegistry.get("flux") is Flux and ModelRegistry.get("sd3") is SD3
    from simpletuner_tpu_torch.models.pixart import PixartSigma
    from simpletuner_tpu_torch.models.sd1x import SD1x, SD2x

    assert ModelRegistry.get("sd15") is SD1x and ModelRegistry.get("sd21") is SD2x
    assert ModelRegistry.get("pixart") is ModelRegistry.get("pixart_sigma") is PixartSigma
    from simpletuner_tpu_torch.models.ltxvideo2 import LTXVideo2

    assert ModelRegistry.get("ltx2") is ModelRegistry.get("ltxvideo2") is LTXVideo2
    from simpletuner_tpu_torch.models.ace_step import ACEStep
    from simpletuner_tpu_torch.models.extended import WanS2V

    assert ModelRegistry.get("ace_step") is ACEStep and ModelRegistry.get("wan_s2v") is WanS2V
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 6"):
        ModelRegistry.get("heartmula")
    for registry in (ModelRegistry, JaxModelRegistry):
        with pytest.raises(KeyError):
            registry.metadata("nope")


@pytest.mark.parametrize("enabled", [True, False])
def test_ideogram_prompting_copy_matches(enabled):
    """``models/ideogram/prompting.py`` is a copy of the JAX module: the
    same body, and on plain prompts (camera words, hex palettes, non-ASCII),
    JSON prompts (partial, with elements, bboxes, text elements and palettes
    past the caps), invalid JSON and empty input, with the auto-json path on
    and off, the same captions, and the same canonical dicts."""
    from simpletuner_tpu.models.ideogram import prompting as jax_prompting

    from simpletuner_tpu_torch.models.ideogram import prompting

    body = lambda path: path.read_text().split('"""', 2)[2]  # noqa: E731 (past the module docstring)
    assert body(REPO / "simpletuner_tpu_torch/models/ideogram/prompting.py") == \
        body(REPO / "simpletuner_tpu/models/ideogram/prompting.py")
    palette = " ".join(f"#{i:02x}{i:02x}A0" for i in range(20))
    prompts = [
        "a lighthouse on a basalt cliff at dusk", "35mm film photo of a cat, bokeh #ff00aa #FF00AA",
        f"poster in {palette}", "café au lait, ünïcödé", "", "   ", "{not json", "[1, 2]",
        json.dumps({"high_level_description": "a sign", "compositional_deconstruction": {"elements": [
            {"type": "text", "text": "OPEN  24h", "desc": "neon", "bbox": [1.7, 2, 30, 40.2],
             "color_palette": ["#aaaaaa", "#AAAAAA", "#123456", "bad", "#654321", "#111111", "#222222",
                               "#333333"]},
            {"type": "weird", "label": "a dog"}, "skip me"]}}),
        json.dumps({"description": "cinematic shot", "style_description": {"photo": "wide", "lighting": ""}}),
        json.dumps({"style_description": {"art_style": "ink", "colour_palette": "#abcdef and #ABCDEF"}}),
    ]
    for prompt in prompts:
        assert prompting.maybe_convert_prompt_to_ideogram_json(prompt, enabled=enabled) == \
            jax_prompting.maybe_convert_prompt_to_ideogram_json(prompt, enabled=enabled), prompt
        assert prompting.prompt_to_ideogram_json_caption(prompt) == jax_prompting.prompt_to_ideogram_json_caption(prompt)
    assert prompting.maybe_convert_prompt_to_ideogram_json(None, enabled=False) is None


@pytest.mark.parametrize("path", ["data/audio.py", "models/ace_step/lyrics.py"])
def test_audio_copies_match(path):
    """``data/audio.py`` and ACE-Step's ``lyrics.py`` are copies of the JAX
    modules: the same body past the module docstring (their behaviour on
    seeded WAVs and a seeded vocab is held in test_torch_audio.py and
    test_torch_ace_step.py)."""
    body = lambda module: module.read_text().split('"""', 2)[2]  # noqa: E731 (past the module docstring)
    assert body(REPO / "simpletuner_tpu_torch" / path) == body(REPO / "simpletuner_tpu" / path)
