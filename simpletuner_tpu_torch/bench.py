"""Flux LoRA train-step benchmark on one CUDA device.

PyTorch counterpart of ``bench.py::flagship`` (bench.py:84-275) and
``bench.py::flux_step_flops`` (:61): full Flux.1-dev (19 double + 38 single
blocks, hidden 3072, 24 x 128 heads, guidance embedding), a frozen base,
rank-16 f32 LoRA on the ``flux_lora_target=all`` modules, AdamW at lr 1e-4,
1024 px (4096 image + 512 T5 tokens, the T5 padding masked), batch 1, and by
default the JAX flagship's base and remat: an int8 frozen base
(``base_model_precision=int8-quanto``) with ``quantized_matmul=full`` (int8
forward and dx products) and remat policy ``attn``.  ``quant="int4"`` packs the
base to 4 bits, ``quant="none"`` keeps it bf16; ``skip_last`` leaves the last
N single-stream blocks unchecked (``BENCH_SKIP_LAST`` in bench.py).

Weights are seeded random (no Flux checkpoint is in the repository), with
the AdaLN modulation weights drawn like every other kernel (their zero init
would close every gate and keep attention off the loss) and every LoRA
tensor at 0.01 (as bench.py:195-198 sets them); the base is quantized after
that, one layer at a time, as ``create_train_state`` does.  MFU counts model
flops only (forward x 3, remat recompute not counted) against the card's
dense bf16 peak, whatever the base, as bench.py:254-255 does.
``chip_smoke.py`` phase 8 drives it.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from .inference import config_namespace
from .models.flux import Flux, FluxConfig
from .models.layers import init_parameters, lecun_normal_, lora_parameters
from .ops import flash_bwd_dkv_kernel, flash_bwd_dq_kernel, flash_fwd_kernel
from .training.optimizers import get_optimizer
from .training.quantization import int8_matmul
from .training.schedules import get_lr_schedule
from .training.train_state import build_train_step, create_train_state

# dense bf16 tensor-core peaks (NVIDIA data sheets), by device-name fragment
PEAK_FLOPS = (("H100 80GB HBM3", 989e12), ("H100 SXM", 989e12), ("H100 PCIe", 756e12))
KERNELS = (flash_fwd_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel)
TXT_LEN = 512  # T5-XXL max length


def peak_flops(device_name: Optional[str] = None) -> float:
    """Dense bf16 peak of the card; an unknown card raises instead of guessing."""
    name = device_name or torch.cuda.get_device_name(0)
    for fragment, flops in PEAK_FLOPS:
        if fragment in name:
            return flops
    raise ValueError(f"no published bf16 peak for {name!r}; add it to PEAK_FLOPS")


def flux_step_flops(arch: FluxConfig, batch: int, s_img: int, s_txt: int) -> float:
    """Analytic model matmul flops of one train step (forward x 3; remat
    recompute is hardware work, not model work), the JAX bench's formula."""
    h = arch.hidden_size
    s = s_img + s_txt
    mlp = arch.mlp_ratio
    double = 2 * h * h * (3 + 1 + 2 * mlp)
    single = 2 * h * h * (3 + mlp) + 2 * h * h * (1 + mlp)
    attn = 4 * s * h
    fwd = batch * s * (arch.depth_double * (double + attn) + arch.depth_single * (single + attn))
    fwd += batch * (s_img * 2 * arch.in_channels * h * 2 + s_txt * 2 * arch.txt_in_features * h)
    return fwd * 3.0


def flagship_config(remat_policy: str = "attn", quant: str = "int8", quantized_matmul: str = "full",
                    skip_last: int = 0) -> Dict:
    """The JAX flagship's training config (bench.py:109-131); ``quant`` is
    "int8", "int4" or "none" (a bf16 base)."""
    if quant not in ("int8", "int4", "none"):
        raise ValueError(f"quant must be int8, int4 or none, got {quant!r}")
    return {
        "model_family": "flux", "model_flavour": "dev", "model_type": "lora", "lora_rank": 16,
        "flux_lora_target": "all", "optimizer": "adamw", "learning_rate": 1e-4, "max_train_steps": 1000,
        "lr_scheduler": "constant", "mixed_precision": "bf16", "gradient_checkpointing": True,
        "gradient_checkpointing_policy": remat_policy, "gradient_checkpointing_skip_last": skip_last,
        "flux_attention_masked_training": True, "quantized_matmul": quantized_matmul,
        "base_model_precision": "no_change" if quant == "none" else f"{quant}-quanto",
    }


@torch.no_grad()
def perturb_adaln(module: torch.nn.Module, generator: torch.Generator) -> None:
    """Give the AdaLN-Zero modulation weights the lecun-normal draw of every other kernel."""
    for name, param in module.named_parameters():
        if name.endswith(("_mod.lin.weight", "modulation.lin.weight")):
            lecun_normal_(param, param.shape[1], generator)


def flagship_batch(arch: FluxConfig, generator: torch.Generator, resolution: int = 1024, batch_size: int = 1,
                   txt_valid: int = 77) -> Dict[str, torch.Tensor]:
    """Seeded latents and prompt embeds; T5 tokens past ``txt_valid`` are padding."""
    dev = generator.device
    latent = resolution // 8
    masks = torch.zeros((batch_size, TXT_LEN), dtype=torch.int64, device=dev)
    masks[:, :txt_valid] = 1
    return {
        "latents": torch.randn((batch_size, latent, latent, arch.in_channels // 4), generator=generator, device=dev),
        "t5_embeds": torch.randn((batch_size, TXT_LEN, arch.txt_in_features), generator=generator, device=dev),
        "pooled_embeds": torch.randn((batch_size, arch.vec_in_features), generator=generator, device=dev),
        "t5_masks": masks,
    }


# kernel-name fragments of each device-time bucket, first match wins
BUCKETS = (
    ("flash_fwd", ("flash_fwd_kernel",)),
    ("flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("int8_gemm", ("gemm_s8", "imma", "i8i8", "s8s8")),
    ("bf16_gemm", ("gemm", "nvjet", "cutlass", "xmma")),
)


def profile_step(step) -> Dict:
    """One call of ``step`` under ``torch.profiler``: device ms and launches
    by kernel bucket (elementwise and copies in ``other``), and the wall
    time of the traced call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3
    buckets = {name: [0.0, 0] for name, _ in BUCKETS}
    buckets["other"] = [0.0, 0]
    for event in prof.key_averages():
        if event.device_type != DeviceType.CUDA:
            continue
        key = event.key.lower()
        name = next((n for n, tags in BUCKETS if any(tag in key for tag in tags)), "other")
        buckets[name][0] += event.device_time_total / 1e3
        buckets[name][1] += event.count
    device_ms = sum(ms for ms, _ in buckets.values())
    return {"bucket_ms": {k: v[0] for k, v in buckets.items()}, "bucket_launches": {k: v[1] for k, v in buckets.items()},
            "device_ms": device_ms, "traced_wall_ms": wall_ms}


def flagship(
    steps: int = 4,
    remat_policy: str = "attn",
    warmup: int = 2,
    seed: int = 0,
    resolution: int = 1024,
    quant: str = "int8",
    quantized_matmul: str = "full",
    skip_last: int = 0,
    profile: bool = False,
) -> Dict:
    """Train ``warmup`` + ``steps`` LoRA steps of full-width Flux.1-dev on the
    card and time the last ``steps``; with ``profile``, one more step under
    ``torch.profiler`` gives the device time by kernel bucket."""
    if not torch.cuda.is_available():
        raise RuntimeError("the flagship benchmark needs a CUDA device")
    dev = torch.device("cuda")
    config = config_namespace(flagship_config(remat_policy, quant, quantized_matmul, skip_last))
    arch = FluxConfig()
    model = Flux(config, arch=arch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        module = init_parameters(model.create_module(), gen)
    perturb_adaln(module, gen)
    with torch.no_grad():
        for param in lora_parameters(module).values():
            param.fill_(0.01)
    n_params = sum(p.numel() for p in module.parameters())
    schedule = get_lr_schedule(config, config.max_train_steps)
    tx = get_optimizer(config, schedule)
    state = create_train_state(model, module, tx, quantize_mode=model.base_precision)
    step_fn = build_train_step(model, tx, schedule)
    batch = flagship_batch(arch, gen, resolution)
    before = {k: p.detach().clone() for k, p in state.trainable.items()}
    n_lora = sum(p.numel() for p in state.trainable.values())
    base_gib = sum(t.numel() * t.element_size() for name, t in module.state_dict().items()
                   if name.rpartition(".")[2] not in ("lora_A", "lora_B")) / 2**30

    losses = []
    for _ in range(warmup):
        state, metrics = step_fn(state, batch, gen)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = [k.launches for k in KERNELS]
    int_mm = int8_matmul.launches
    step_s = []
    for _ in range(steps):
        start = time.perf_counter()
        state, metrics = step_fn(state, batch, gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - start)
        losses.append(metrics["loss"])
    launches = {k.name: (k.launches - c) / steps for k, c in zip(KERNELS, counts)}
    int_mm = (int8_matmul.launches - int_mm) / steps
    peak = torch.cuda.max_memory_allocated()
    traced = profile_step(lambda: step_fn(state, batch, gen)) if profile else None
    delta = torch.sqrt(sum((p.detach() - before[k]).float().square().sum() for k, p in state.trainable.items()))

    s_img = (resolution // 16) ** 2
    dt = sum(step_s) / len(step_s)
    flops = flux_step_flops(arch, 1, s_img, TXT_LEN)
    result = {
        "device": torch.cuda.get_device_name(0),
        "params_b": n_params / 1e9,
        "lora_params_m": n_lora / 1e6,
        "resolution": resolution,
        "batch": 1,
        "remat_policy": remat_policy,
        "skip_last": skip_last,
        # the modes the run used, resolved from its config (bench.py:271-274)
        "quant": model.base_precision or "none",
        "quantized_matmul": model.quantized_matmul,
        "base_gib": base_gib,
        "steps": steps,
        "s_per_step": dt,
        "s_per_step_median": sorted(step_s)[len(step_s) // 2],
        "step_s": step_s,
        "samples_per_s": 1.0 / dt,
        "model_tflop_per_step": flops / 1e12,
        "mfu": flops / dt / peak_flops(),
        "peak_gib": peak / 2**30,
        "losses": [float(x) for x in losses],
        "grad_norm": float(metrics["grad_norm"]),
        "skipped_nonfinite": float(metrics["skipped_nonfinite"]),
        "lora_delta": float(delta),
        "launches_per_step": launches,
        "int_mm_per_step": int_mm,
    }
    if traced is not None:
        traced["idle_share_vs_median"] = 1 - traced["device_ms"] / 1e3 / result["s_per_step_median"]
        result["profile"] = traced
    del state, module, before
    torch.cuda.empty_cache()
    return result

