"""The torch port's FLUX.2 trainer against the JAX ``Trainer``, on the CPU.

Both trainers run the tiny FLUX.2 (the dev layout: guidance embedding, 4
latent channels, which the tiny VAE makes) from the JAX exporter's diffusers
file of one seeded tree, warm-started from one seeded adapter, on one text
cache of Mistral states (16 tokens, 5 valid: the mask is kept in the payload
and dropped by the collate), with the same noise and sigmas (the Flux
trainer test's recipe, 3 steps); then ``run_inference`` renders from the
port's checkpoint.  The published arch cannot take its trainer's latents
(test_torch_flux2.py).  Every tolerance is stated where it is checked.
"""

import os

import numpy as np
import pytest

from simpletuner_tpu.models.weight_export import export_flux2_to_diffusers

from test_torch_flux2 import _jax_params, _pair
from test_torch_qwen_image_trainer import run_both, seed_text_cache


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    from test_torch_trainer import _values, _write_images

    root = tmp_path_factory.mktemp("flux2_trainer")
    _write_images(root / "data")
    seed_text_cache(root, "flux2")
    values = lambda out, **extra: _values(root, out, model_family="flux2", max_train_steps=3,  # noqa: E731
                                          checkpointing_steps=3, flux_guidance_value=2.5, **extra)
    return (root, *run_both(root, values, render=True, export=export_flux2_to_diffusers, params=_jax_params,
                            steps=3, pair=_pair))


def test_trainer_matches_jax(trainer_runs):
    """3 steps, no state shared between the runs: per-step loss within 1e-5
    relative, grad norm within ``GRAD_REL``; the LoRA export holds the JAX
    map's names (the single blocks' fused ``to_qkv_mlp_proj`` among them) and
    its tensors within ``GRAD_REL``; both trainers built the tiny FLUX.2 with
    its guidance input, the 4-channel tiny VAE and batches without the mask."""
    from test_torch_qwen_image_trainer import assert_trajectories_match

    root, jax_trainer, port_trainer, _ = trainer_runs
    assert_trajectories_match(root, ".attn.to_qkv_mlp_proj.lora_", steps=3)
    assert port_trainer.model.NAME == jax_trainer.model.NAME == "flux2"
    assert port_trainer.model.arch.guidance_embed and port_trainer.model.latent_channels == 4
    assert port_trainer.vae.config.latent_channels == jax_trainer.vae.config.latent_channels == 4
    batch = port_trainer._example_batch()
    assert sorted(k for k in batch if "embeds" in k or "mask" in k) == ["text_embeds"]


def test_checkpoint_inference_renders_a_png(trainer_runs):
    """``run_inference`` (what ``simpletuner-tpu-torch inference --checkpoint``
    runs) from the port's checkpoint-3 on the CPU: the tiny Mistral encodes
    the prompt, 2 guidance-distilled flow Euler steps (one forward each),
    one square RGB PNG that is not flat."""
    from PIL import Image

    root, _, _, rendered = trainer_runs
    output = os.path.join(root, "render", "validation")
    (image,) = [os.path.join(output, f) for f in os.listdir(output)]
    pixels = np.asarray(Image.open(image))
    assert rendered == 0 and image.endswith(".png") and pixels.ndim == 3 and pixels.shape[-1] == 3
    assert pixels.shape[0] == pixels.shape[1] and pixels.std() > 0
