"""The torch port's HiDream-I1 trainer against the JAX ``Trainer``, on the CPU.

Both trainers run tiny HiDream from the JAX exporter's diffusers file of one
seeded tree, warm-started from one seeded adapter, with the load-balancing
loss on (``hidream_use_load_balancing_loss``), on one text cache of T5
states, one Llama layer (what ``encode_text`` stacks) and the pooled CLIP
states, with the same noise and sigmas (the Flux trainer test's recipe, cut
to 2 steps), then render from the port's checkpoint through the four tiny
encoders.  The tiny preset does not fit its own tiny CLIPs in either
package (their pooled states are 32 + 64 wide where the tiny arch reads
32), so both packages' tiny arch takes 96 here.  Every tolerance is stated
where it is checked.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
from safetensors.numpy import save_file as np_save_file

from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.hidream import transformer as jax_hd
from simpletuner_tpu.models.weight_export import export_hidream_to_diffusers

from simpletuner_tpu_torch.models.hidream import transformer as hd
from simpletuner_tpu_torch.models.weight_import import load_safetensors_file
from simpletuner_tpu_torch.training.lora import save_lora_safetensors

from test_torch_chroma_trainer import _seeded_adapters
from test_torch_hidream import GRAD_REL, _jax_params, _pair
from torch_parity import rel

POOLED = 96  # the tiny CLIP-L (32) and CLIP-G (64) pooled states, concatenated


def seed_text_cache(root, count=4, prefix="photo"):
    """The captions' payloads, cached before either run: 16 T5 states (5
    valid), one Llama layer of 16 states and the pooled CLIP states."""
    from simpletuner_tpu_torch.caching.text_embeds import TextEmbeddingCache
    from simpletuner_tpu_torch.data.backends.local import LocalDataBackend

    cache = TextEmbeddingCache("embeds", LocalDataBackend("embeds"), str(root / "cache" / "text"), "hidream")
    rng = np.random.default_rng(5)
    for i in range(count):
        cache.save(f"{prefix} {i}", {"t5_embeds": rng.standard_normal((16, 32)).astype(np.float32),
                                     "llama_embeds": rng.standard_normal((1, 16, 32)).astype(np.float32),
                                     "pooled_embeds": rng.standard_normal(POOLED).astype(np.float32),
                                     "attention_mask": (np.arange(16) < 5).astype(np.int32)})


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    from simpletuner_tpu.data.dataset import MultiDatasetIterator as JaxIterator
    from simpletuner_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from simpletuner_tpu.training import trainer as jax_trainer_module
    from simpletuner_tpu.training.trainer import Trainer as JaxTrainer

    from simpletuner_tpu_torch.data.dataset import MultiDatasetIterator
    from simpletuner_tpu_torch.inference import run_inference
    from simpletuner_tpu_torch.training.trainer import Trainer

    from test_torch_trainer import _overriding, _values, _write_images

    root = tmp_path_factory.mktemp("hidream_trainer")
    _write_images(root / "data")
    seed_text_cache(root)
    values = lambda out, **extra: _values(root, out, model_family="hidream", max_train_steps=2,  # noqa: E731
                                          hidream_use_load_balancing_loss=True, **extra)
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    with pytest.MonkeyPatch.context() as mp:
        for module in (jax_hd, hd):
            tiny = module.HiDreamConfig.tiny
            mp.setattr(module.HiDreamConfig, "tiny",
                       classmethod(lambda c, tiny=tiny: dataclasses.replace(tiny(), pooled_dim=POOLED)))
        jmodel, port_model = _pair(values("x"))
        path = str(root / "transformer.safetensors")
        exported = export_hidream_to_diffusers(_jax_params(port_model.arch, 3), jmodel.arch)
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
        config = root / "render.json"
        config.write_text(json.dumps(values("port", pretrained_model_name_or_path=path, validation_guidance=2.0,
                                            validation_resolution=32)))
        rendered = run_inference("a lighthouse at dusk", checkpoint=str(root / "port" / "checkpoint-2"),
                                 config_path=str(config), output=str(root / "render"), steps=2, device="cpu")
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])
    return root, jax_trainer, port_trainer, rendered


def test_trainer_matches_jax_with_moe_gate_loss(trainer_runs):
    """2 steps, no state shared between the runs: both metrics files hold
    the same keys, ``moe_gate_loss`` among them at every step; per-step loss
    within 1e-5 relative (``TRAJECTORY_TOL``), ``moe_gate_loss`` within 1e-5
    relative, grad norm within ``GRAD_REL``; the LoRA export holds the JAX
    map's names (the caption projections' and shared experts' among them)
    and, within ``GRAD_REL`` in relative L2, its tensors; both trainers
    built the family with the load-balancing loss on (weight 0.01) and the
    4-channel tiny VAE."""
    from test_torch_trainer import TRAJECTORY_TOL, _metrics

    root, jax_trainer, port_trainer, _ = trainer_runs
    ours, theirs = _metrics(root / "port"), _metrics(root / "jax")
    assert [m["step"] for m in ours] == [m["step"] for m in theirs] == [1, 2]
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) and "moe_gate_loss" in a, (a, b)
        assert abs(a["loss"] - b["loss"]) <= TRAJECTORY_TOL * max(1.0, abs(b["loss"])), (a["step"], a, b)
        assert abs(a["moe_gate_loss"] - b["moe_gate_loss"]) <= 1e-5 * abs(b["moe_gate_loss"]), (a["step"], a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= GRAD_REL * abs(b["grad_norm"]), (a["step"], a, b)
    export = "checkpoint-2/pytorch_lora_weights.safetensors"
    mine, jax_file = load_safetensors_file(str(root / "port" / export)), load_safetensors_file(str(root / "jax" / export))
    assert sorted(mine) == sorted(jax_file)
    assert any(".caption_proj_0.lora_" in k for k in mine) and any(".shared_experts.w1.lora_" in k for k in mine)
    keys = sorted(mine)
    assert rel(np.concatenate([mine[k].numpy().ravel() for k in keys]),
               np.concatenate([jax_file[k].numpy().ravel() for k in keys])) < GRAD_REL
    assert port_trainer.model.moe_aux_weight == jax_trainer.model.moe_aux_weight == 0.01
    assert port_trainer.vae.config.latent_channels == jax_trainer.vae.config.latent_channels == 4
    batch = port_trainer._example_batch()
    assert sorted(k for k in batch if "embeds" in k or "mask" in k) == ["llama_embeds", "pooled_embeds", "t5_embeds"]


def test_checkpoint_inference_renders_a_png(trainer_runs):
    """``run_inference`` from the port's checkpoint-2 on the CPU: the four
    tiny encoders (CLIP-L, CLIP-G, T5, Llama) encode the prompt, 2 true-CFG
    flow Euler steps, one square RGB PNG that is not flat."""
    from PIL import Image

    root, _, _, rendered = trainer_runs
    output = os.path.join(root, "render", "validation")
    (image,) = [os.path.join(output, f) for f in os.listdir(output)]
    pixels = np.asarray(Image.open(image))
    assert rendered == 0 and image.endswith(".png") and pixels.ndim == 3 and pixels.shape[-1] == 3
    assert pixels.shape[0] == pixels.shape[1] and pixels.std() > 0
