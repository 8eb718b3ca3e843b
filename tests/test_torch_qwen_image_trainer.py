"""The torch port's Qwen-Image, Z-Image and MageFlow trainers against the JAX ``Trainer``, on the CPU.

Both trainers run each tiny family from the JAX exporter's diffusers file of
one seeded tree, warm-started from one seeded adapter, on one text cache of
Qwen states (16 tokens, 5 valid: the mask is kept in the payload and dropped
by the collate, so the pads attend), with the same noise and sigmas (the
Flux trainer test's recipe, cut to 2 steps); Qwen-Image then renders from
the port's checkpoint.  MageFlow's tiny preset works (the tiny VAE's 4
channels meet its tiny arch), unlike its published one
(test_torch_qwen_image.py).  Every tolerance is stated where it is checked.
"""

import json
import os

import jax
import numpy as np
import pytest
from safetensors.numpy import save_file as np_save_file

from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.weight_export import export_qwen_image_to_diffusers

from simpletuner_tpu_torch.models.weight_import import load_safetensors_file
from simpletuner_tpu_torch.training.lora import save_lora_safetensors

from test_torch_chroma_trainer import _seeded_adapters
from test_torch_qwen_image import GRAD_REL, _jax_params, _pair
from torch_parity import rel


def seed_text_cache(root, family, count=4, prefix="photo"):
    """The captions' payloads, cached before either run (the tiny tokenizer's
    salted hash would give every process other embeds): 16 Qwen states with
    5 valid and the mask."""
    from simpletuner_tpu_torch.caching.text_embeds import TextEmbeddingCache
    from simpletuner_tpu_torch.data.backends.local import LocalDataBackend

    cache = TextEmbeddingCache("embeds", LocalDataBackend("embeds"), str(root / "cache" / "text"), family)
    rng = np.random.default_rng(5)
    for i in range(count):
        cache.save(f"{prefix} {i}", {"text_embeds": rng.standard_normal((16, 32)).astype(np.float32),
                                     "attention_mask": (np.arange(16) < 5).astype(np.int32)})


def run_both(root, values, render, export=export_qwen_image_to_diffusers, params=_jax_params, steps=2, pair=_pair):
    """The JAX trainer, then the port's (the families ``pair`` builds), on
    one cache, with the same noise and sigmas, from the file ``export``
    writes of ``params``' seeded tree;
    with ``render``, ``run_inference`` from the port's checkpoint at
    ``steps``.  Returns both trainers and the render's exit code."""
    from simpletuner_tpu.data.dataset import MultiDatasetIterator as JaxIterator
    from simpletuner_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from simpletuner_tpu.training import trainer as jax_trainer_module
    from simpletuner_tpu.training.trainer import Trainer as JaxTrainer

    from simpletuner_tpu_torch.data.dataset import MultiDatasetIterator
    from simpletuner_tpu_torch.inference import run_inference
    from simpletuner_tpu_torch.training.trainer import Trainer

    from test_torch_trainer import _overriding

    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    rendered = None
    with pytest.MonkeyPatch.context() as mp:
        jmodel, port_model = pair(values("x"))
        path = str(root / "transformer.safetensors")
        exported = export(params(port_model.arch, 3), jmodel.arch)
        np_save_file({k: np.ascontiguousarray(v) for k, v in exported.items()}, path)
        lora_path = str(root / "init_lora.safetensors")
        save_lora_safetensors(port_model, _seeded_adapters(port_model, 4, scale=0.05), lora_path)
        extra = {"pretrained_model_name_or_path": path, "init_lora": lora_path}
        mp.setattr(jax_trainer_module, "build_mesh", lambda config: jax_build_mesh(config, devices=jax.devices()[:1]))
        mp.setattr(JaxIterator, "next_batch", _overriding(JaxIterator.next_batch))
        jax_trainer = JaxTrainer(config=JaxTrainingConfig(values("jax", **extra)))
        jax_trainer.run()
        mp.setattr(MultiDatasetIterator, "next_batch", _overriding(MultiDatasetIterator.next_batch))
        port_trainer = Trainer(config=values("port", **extra), device="cpu")
        port_trainer.run()
        if render:
            config = root / "render.json"
            config.write_text(json.dumps(values("port", pretrained_model_name_or_path=path, validation_guidance=2.0,
                                                validation_resolution=32)))
            rendered = run_inference("a lighthouse at dusk", checkpoint=str(root / "port" / f"checkpoint-{steps}"),
                                     config_path=str(config), output=str(root / "render"), steps=2, device="cpu")
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])
    return jax_trainer, port_trainer, rendered


def assert_trajectories_match(root, marker, steps=2):
    """``steps`` steps, no state shared between the runs: per-step loss within 1e-5
    relative (``TRAJECTORY_TOL``), grad norm within ``GRAD_REL``; the LoRA
    export holds the JAX map's names (``marker`` among them) and, within
    ``GRAD_REL`` in relative L2, its tensors."""
    from test_torch_trainer import TRAJECTORY_TOL, _metrics

    ours, theirs = _metrics(root / "port"), _metrics(root / "jax")
    assert [m["step"] for m in ours] == [m["step"] for m in theirs] == list(range(1, steps + 1))
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b), (a, b)
        assert abs(a["loss"] - b["loss"]) <= TRAJECTORY_TOL * max(1.0, abs(b["loss"])), (a["step"], a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= GRAD_REL * abs(b["grad_norm"]), (a["step"], a, b)
    export = f"checkpoint-{steps}/pytorch_lora_weights.safetensors"
    mine, jax_file = load_safetensors_file(str(root / "port" / export)), load_safetensors_file(str(root / "jax" / export))
    assert sorted(mine) == sorted(jax_file) and any(marker in k for k in mine)
    keys = sorted(mine)
    assert rel(np.concatenate([mine[k].numpy().ravel() for k in keys]),
               np.concatenate([jax_file[k].numpy().ravel() for k in keys])) < GRAD_REL


@pytest.fixture(scope="module", params=["qwen_image", "z_image", "mageflow"])
def trainer_runs(request, tmp_path_factory):
    from test_torch_trainer import _values, _write_images

    family = request.param
    root = tmp_path_factory.mktemp(f"{family}_trainer")
    _write_images(root / "data")
    seed_text_cache(root, family)
    values = lambda out, **extra: _values(root, out, model_family=family, max_train_steps=2, **extra)  # noqa: E731
    return (family, root, *run_both(root, values, render=family == "qwen_image"))


def test_trainer_matches_jax(trainer_runs):
    """Each family's trajectory (``assert_trajectories_match``, the text
    attention's ``add_q_proj`` among the exported names); both trainers
    built the family and the 4-channel tiny VAE, and batches without the
    Qwen mask."""
    family, root, jax_trainer, port_trainer, _ = trainer_runs
    assert_trajectories_match(root, ".attn.add_q_proj.lora_")
    assert port_trainer.model.NAME == jax_trainer.model.NAME == family
    assert port_trainer.model.arch.txt_rope == (family == "qwen_image")
    assert port_trainer.vae.config.latent_channels == jax_trainer.vae.config.latent_channels == 4
    batch = port_trainer._example_batch()
    assert sorted(k for k in batch if "embeds" in k or "mask" in k) == ["text_embeds"]


def test_checkpoint_inference_renders_a_png(trainer_runs):
    """``run_inference`` (what ``simpletuner-tpu-torch inference --checkpoint``
    runs) from the port's Qwen-Image checkpoint-2 on the CPU: the tiny Qwen2
    encodes the prompt, 2 true-CFG flow Euler steps, one square RGB PNG that
    is not flat; the other two families' runs render nothing."""
    from PIL import Image

    family, root, _, _, rendered = trainer_runs
    if family != "qwen_image":
        assert rendered is None and not os.path.exists(os.path.join(root, "render"))
        return
    output = os.path.join(root, "render", "validation")
    (image,) = [os.path.join(output, f) for f in os.listdir(output)]
    pixels = np.asarray(Image.open(image))
    assert rendered == 0 and image.endswith(".png") and pixels.ndim == 3 and pixels.shape[-1] == 3
    assert pixels.shape[0] == pixels.shape[1] and pixels.std() > 0
