"""The torch port's Kolors trainer against the JAX ``Trainer``, on the CPU.

Both trainers run the tiny Kolors UNet from one seeded diffusers file,
warm-started from one seeded adapter, on one text cache of ChatGLM payloads
(16 states of 32, the pooled vector and the mask, which the collate drops),
with the same noise and timesteps: 3 steps of min-SNR (gamma 5) epsilon
training on the 4-channel tiny VAE's latents (the SDXL trainer test's
recipe).  Then ``run_inference`` renders from the port's checkpoint with
true CFG (DDIM), the tiny ChatGLM encoding the prompt.  Every tolerance is
stated where it is checked.
"""

import json
import os

import numpy as np
import pytest

from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.models import layers as jl

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models.checkpoint_layouts import unet_checkpoint_shapes
from simpletuner_tpu_torch.models.kolors import Kolors
from simpletuner_tpu_torch.training.lora import save_lora_safetensors

from test_torch_chroma_trainer import _seeded_adapters
from test_torch_weight_import import _seeded

STEPS = 3


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    import jax

    from simpletuner_tpu.data.dataset import MultiDatasetIterator as JaxIterator
    from simpletuner_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from simpletuner_tpu.training import trainer as jax_trainer_module
    from simpletuner_tpu.training.trainer import Trainer as JaxTrainer

    from simpletuner_tpu_torch.caching.text_embeds import TextEmbeddingCache
    from simpletuner_tpu_torch.data.backends.local import LocalDataBackend
    from simpletuner_tpu_torch.data.dataset import MultiDatasetIterator
    from simpletuner_tpu_torch.inference import run_inference
    from simpletuner_tpu_torch.models.weight_import import save_safetensors
    from simpletuner_tpu_torch.training.trainer import Trainer

    from test_torch_sdxl import _overriding_ddpm
    from test_torch_trainer import _values, _write_images

    root = tmp_path_factory.mktemp("kolors_trainer")
    _write_images(root / "data")
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    values = lambda out, **extra: _values(root, out, model_family="kolors", snr_gamma=5.0,  # noqa: E731
                                          max_train_steps=STEPS, checkpointing_steps=STEPS, **extra)
    port_model = Kolors(config_namespace(values("x")))
    unet_path = str(root / "unet.safetensors")
    save_safetensors(_seeded(unet_checkpoint_shapes(port_model.arch), seed=3, dtype="f32"), unet_path)
    lora_path = str(root / "init_lora.safetensors")
    save_lora_safetensors(port_model, _seeded_adapters(port_model, 4, scale=0.05), lora_path)
    extra = {"pretrained_model_name_or_path": unet_path, "init_lora": lora_path}
    # the captions' payloads, cached before either run (the tiny tokenizer's
    # salted hash would give every process other embeds)
    cache = TextEmbeddingCache("embeds", LocalDataBackend("embeds"), str(root / "cache" / "text"), "kolors")
    rng = np.random.default_rng(5)
    for i in range(4):
        cache.save(f"photo {i}", {"text_embeds": rng.standard_normal((16, 32)).astype(np.float32),
                                  "pooled_embeds": rng.standard_normal(32).astype(np.float32),
                                  "attention_mask": (np.arange(16) < 6).astype(np.int32)})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer_module, "build_mesh", lambda config: jax_build_mesh(config, devices=jax.devices()[:1]))
        mp.setattr(JaxIterator, "next_batch", _overriding_ddpm(JaxIterator.next_batch))
        jax_trainer = JaxTrainer(config=JaxTrainingConfig(values("jax", **extra)))
        jax_trainer.run()
        mp.setattr(MultiDatasetIterator, "next_batch", _overriding_ddpm(MultiDatasetIterator.next_batch))
        port_trainer = Trainer(config=values("port", **extra), device="cpu")
        port_trainer.run()
        config = root / "render.json"
        config.write_text(json.dumps(values("port", pretrained_model_name_or_path=unet_path, validation_guidance=5.0,
                                            validation_resolution=32)))
        rendered = run_inference("a lighthouse at dusk", checkpoint=str(root / "port" / f"checkpoint-{STEPS}"),
                                 config_path=str(config), output=str(root / "render"), steps=2, device="cpu")
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])
    return root, jax_trainer, port_trainer, rendered


def test_trainer_matches_jax(trainer_runs):
    """3 steps, no state shared between the runs: per-step loss within 1e-5
    relative, grad norm within ``GRAD_REL``; the LoRA export holds the JAX
    ``unet_key_map`` names (the cross-attention's ``attn2.to_k`` among them)
    and its tensors within ``GRAD_REL``; both trainers built Kolors with the
    4-channel tiny VAE and batches of the ChatGLM states and pooled vectors
    without the mask."""
    from test_torch_qwen_image_trainer import assert_trajectories_match

    root, jax_trainer, port_trainer, _ = trainer_runs
    assert_trajectories_match(root, ".attn2.to_k.lora_", steps=STEPS)
    assert port_trainer.model.NAME == jax_trainer.model.NAME == "kolors"
    assert port_trainer.vae.config.latent_channels == jax_trainer.vae.config.latent_channels == 4
    batch = port_trainer._example_batch()
    assert sorted(k for k in batch if "embeds" in k or "mask" in k) == ["pooled_embeds", "text_embeds"]
    assert batch["pooled_embeds"].shape[-1] == port_trainer.model._pooled_dim == 32


def test_checkpoint_inference_renders_a_png(trainer_runs):
    """``run_inference`` from the port's checkpoint on the CPU: the tiny
    ChatGLM encodes the prompt and its pooled vector, 2 true-CFG DDIM steps,
    one square RGB PNG that is not flat."""
    from PIL import Image

    root, _, _, rendered = trainer_runs
    output = os.path.join(root, "render", "validation")
    (image,) = [os.path.join(output, f) for f in os.listdir(output)]
    pixels = np.asarray(Image.open(image))
    assert rendered == 0 and image.endswith(".png") and pixels.ndim == 3 and pixels.shape[-1] == 3
    assert pixels.shape[0] == pixels.shape[1] and pixels.std() > 0
