#!/usr/bin/env python3
"""Drive the torch port of simpletuner-tpu once on one NVIDIA GPU and check it.

    python3 chip_smoke.py                       # every phase, 1-48
    python3 chip_smoke.py --phases 47           # ACE-Step with all 28 blocks in memory, and 1-3, 7, 14, 15
    python3 chip_smoke.py --phases 14-16,27,28  # the named phases, what they need, and 1-3 and 7

With ``--phases`` the script runs the named phases, the phases whose files
they need (``PHASE_NEEDS``: 25 and 26 need phase 14's Flux VAE, phase 15's
T5-XXL and tokenizer and phase 16's JPEGs; 27 phase 14's CLIP-L, phase 15's
CLIP tokenizer and phase 16's JPEGs; 28 phase 15's files; 29 phase 14's VAE and phase 16's
JPEGs; 30 those, phase 15's T5-XXL and tokenizers and phase 19's CLIP-G; 31 none; 32 phase 16's JPEGs;
33 and 34 phase 14's VAE and phase 16's JPEGs; 35 none; 36 and 38 phase 14's VAE and phase
16's JPEGs; 37 those and phase 15's T5 tokenizer; 39 phase 16's JPEGs; 40, 41 and 43 none; 42
phase 15's T5-XXL and tokenizer; 44 phase 42's clips and phase 43's Gemma-2; 45 none) and
phases 1, 2, 3 and 7 (the
build, and every kernel against its plain version); a named family phase
whose depth a full run cuts writes its full-depth file where the run's
writes leave room (``_full_depth``), and the kernels line holds the rows of
the phases that ran.

Phases (each prints one line, with ``elapsed_s`` since the start; any failure
exits non-zero with no result line):

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compile every hand-written kernel of the render path from csrc/;
3. kernels: the forward kernel against its plain PyTorch version on the
   card, bf16, at the Flux shape masked and unmasked, Flux padding at a ragged
   S = 4173, a ragged S = 1000, packed samples (mixed tiles), narrow heads
   (D = 64, 32), a (B, S, H, D) strided view and SD3.5 Large's (1, 38, 4429,
   64) with no caller mask (the ragged tail), and SDXL's six attention shapes
   at 1024 px (self-attention at (1, 5, 16384, 64), (1, 10, 4096, 64) and
   (1, 20, 1024, 64), and the same queries against 77 CLIP keys, below one
   128-key tile; level 0's keys also as views into a NaN-padded buffer,
   which must give the contiguous output bitwise), each with its kernel,
   plain and SDPA times and bound; rows that see no key exactly
   0 with lse -1e30; kernel, plain and SDPA times (CUDA events, after warm-up;
   SDPA with the T5 mask as a boolean attn_mask is the masked yardstick), the
   bound, and the skip/full/mixed tile counts of the Flux masked call; the
   kernel, plain and SDPA times and the bound at SD3.5 Large's shape;
4. render: the port's inference runtime renders one 1024x1024 image with
   full-width Flux.1-dev (19 double + 38 single blocks, hidden 3072, 24x128
   heads, guidance embedding; depth not cut) and the Flux VAE decoder, from
   seeded random weights, the prompt encoded by phase 15's CLIP-L and
   T5-XXL through Validation.precompute_embeds, 4 Euler steps, unmasked as
   the JAX render is; counts the flash-kernel launches of that run;
5. parity: one full-width denoise call through the kernel against the same
   call through mha_reference, on the same (AdaLN-perturbed) weights, with
   the T5 padding mask collated as the trainer collates it; the denoise call
   timed masked and unmasked (the render's step before and after the repair
   of its mask);
6. profile: one full-width denoise call, unmasked as the render runs it,
   under torch.profiler, device time by kernel bucket and the device's idle
   share of the call;
7. backward kernels: dq, dk and dv from the dq/dkv kernels against the plain
   backward on the card, bf16, at the cases of phase 3 and a cross-attention
   case (200 queries against 512 keys with two 128-key blocks of pad: the dq
   kernel's skip tiles); dk and dv of pad keys and dq of pad queries exactly
   0; gradients of strided inputs in their layout; dq bitwise equal over two
   launches at the Flux masked shape; kernel, plain and SDPA-backward times,
   the bounds and each kernel's share of its bound, at the Flux shape, at
   SD3.5 Large's and at SDXL's six;
8. train step: the flagship LoRA step (simpletuner_tpu_torch.bench.flagship:
   full-width, full-depth Flux.1-dev, rank-16 LoRA, AdamW, 1024 px, T5 padding
   masked): first the JAX flagship's configuration, an int8 frozen base with
   quantized_matmul=full and remat policy attn, then an int4 base (attn), then
   a bf16 base with remat attn and full; the eager step, 2 warm-up and 2 timed
   steps for the first, 1 and 1 for the others (2 and 2 before phases 39-41);
   counts the kernel launches of each run; in a run that names phase 8, the
   first run's device time by kernel bucket from one more step under
   torch.profiler (phase 12 profiles the same step's graphed replay);
9. gradient parity: one step's LoRA gradients through the kernels against the
   same step through mha_reference under autograd, full width, depth cut to
   2 double + 4 single blocks;
10. int8 products: torch._int_mm at the Flux linears' (k, n) with m = 4608
   rows and with one (padded) row, in the forward's and the dx backward's
   operand layouts, each int32 result equal to the float64 product of the same
   int8 operands; int8_dynamic_dot's output and dx against a plain version
   that contracts in float64; times beside bf16 products of the same shapes;
11. gradient parity on an int8 base (quantized_matmul=full): phase 9 again;
12. graphed train step: the int8 flagship of phase 8 (attn) through
   jit_train_step, the step captured as one CUDA graph: two runs of 5 eager
   steps from one snapshot of the adapters, the optimizer state and the
   generator (bitwise equal, or the difference printed and the graph held to
   it), then 5 graph replays from the same snapshot, whose losses, grad norms
   and LoRA tensors must equal the eager ones bitwise; then ``GRAPH_EAGER_TIMED_STEPS``
   eager steps and ``GRAPH_TIMED_STEPS`` replays timed, and one replay profiled
   (device time by bucket, idle share; phase 8 profiles the eager step);
   the launches of a profiled replay as the trace's kernel records give them
   on the card (76 / 57 / 57 flash, 1,069 torch._int_mm), which must equal
   what the capture recorded (a replay runs no wrapper, so the counters count
   the warm-up steps and the capture, and not the replays).  Every
   profiled-replay launch check of the script (this one and each family
   phase's) goes through ``bench.replay_launches``: the replay is profiled
   again while the trace records fewer launches than the capture (three
   attempts in all; each attempt's counts printed), and fails at once on more;
13. full-depth gradient parity: phase 9 at 19 + 38 blocks on a bf16 base;
14. weight import (runs after phase 3): seeded bf16 Flux weights at full width
   (hidden 3072, 24x128 heads) written with the port's safetensors writer,
   at a cut depth (1 double + 1 single block: the write budget) in the BFL
   layout (one file)
   and the diffusers layout (two shards), and at phase 17's depth
   (``train_blocks``: ``TRAIN_CUT_BLOCKS``, 2 + 4 blocks and 1.31B parameters,
   in a run of every phase; 19 + 38 blocks, 11.9B, in a run that names phase
   17 or 18) as one fp8 (e4m3) BFL file, as the published fp8 Flux files are
   (the card's machine ends a run that writes more than 45 GiB in all,
   deleted files included); the Flux VAE
   (diffusers layout, with the quant convs) and CLIP-L at full size; each
   loaded onto the card, both cut layouts bitwise equal, and the fp8 file's
   module equal to the cut one rounded to e4m3 on the tensors they share;
   load seconds and GB/s (the files are read back from the page cache right
   after being written), peak host and device memory; a rank-16 LoRA adapter
   saved and loaded back bitwise;
15. text encoders: CLIP-L (phase 14's file) and T5-XXL at full size (24
   layers, d_model 4096, 64x64 heads, d_ff 10240, gated-gelu; seeded, bf16;
   written for phases 17-19 at full width and 2 of its 24 blocks) encode 16 prompts at T5 length 512 through Flux.encode_text and
   TextEmbeddingCache.compute_embeddings_for_prompts; the payload read back
   bitwise what was encoded; the bf16 T5 output against the f32 module;
   prompts/s and MFU;
16. VAE cache: the Flux VAE encoder (phase 14's file, bf16) through
   VAECache.process_buckets over 24 JPEGs in the three Flux buckets
   (1024x1024, 1152x896, 896x1152), batch 8, with the trainer's encode
   function; every image cached; bf16 latents against the f32 encoder;
   images/s end to end and on the device, MFU, peak GiB.

17. trainer: ``Trainer.run()`` (what ``python -m simpletuner_tpu_torch.train``
   runs) on full-width Flux.1-dev at ``train_blocks()`` (2 + 4 of its 19 + 38
   blocks in a run of every phase, the line's ``depth``, through the
   config's ``model_arch_overrides``; all of them in a run that names phase
   17 or 18) from phase 14's fp8 BFL file and
   Flux dir (phase 15 adds its cut-depth T5-XXL and seeded tokenizer files):
   int8 base with quantized_matmul=full, remat attn, rank-16 LoRA on `all`,
   AdamW 1e-4, the T5 mask in the attention, batch 1 at 1024 px over 8 of
   phase 16's JPEGs in two buckets (one graph each), 8 steps with
   checkpoints at 4 and 8 and the validation prompt rendered at 1024 px with
   4 Euler steps; then a run resumed from checkpoint-4 whose losses and
   final LoRA must equal the straight run's bitwise; each run's kernel
   launches (every kernel must launch), init seconds and peak memory per
   stage, caching rates, capture seconds per shape, median s/step beside
   phase 12's graphed flagship (their ratio at full depth), the idle share of a profiled window of the
   resumed run, checkpoint save and restore seconds and bytes, validation
   seconds.  Its checkpoints refer to the frozen base instead of writing it,
   which keeps the script's disk writes near 40 GB in all (phases 14-15
   write 18 GB and phase 19 18 GB, a full-state checkpoint is 12.3 GB, and
   the runs save five times); ``python -m simpletuner_tpu_torch.bench_checkpoint`` times the
   full-state save and restore.
18. server: the port's training server (``server/app.py``) in this process
   on an ephemeral port with ``device="cuda"``: ``/health``,
   ``/api/hardware`` (must name the H100), ``/api/config/validate``; a
   training job (``POST /api/training/start``) with phase 17's straight-run
   config, its caches and a new output dir, plus an eval split (two of phase
   16's JPEGs that phase 17 does not train on, ``dataset_type: eval``,
   ``eval_steps_interval: 4``, ``eval_timesteps: 4``), which the server runs as ``python -m
   simpletuner_tpu_torch.train --device cuda`` in a child process (which
   builds Flux at phase 17's depth from the config's ``model_arch_overrides``;
   the render job's child alike): its losses,
   grad norms and final LoRA must equal phase 17's straight run bitwise (a
   child's launch counters cannot be read from here: bitwise equality is what
   shows it ran the same kernels and graphs), and it must log a finite
   ``eval_loss`` at steps 4 and 8; then a render job
   (``POST /api/inference/start``: ``cli inference`` in a child process) from
   phase 17's checkpoint-8 (of the resumed run, whose LoRA is the straight
   run's), whose 1024x1024 PNG must equal phase 17's final validation image
   byte for byte, run at the same time as the training job (the server has two
   job slots; one after the other before phases 39-41); the events stream
   (``/api/events``) must show both jobs start and finish.  Prints the parent's allocation before the phase, each
   job's wall time, the time to the first step, the children's peaks and the
   eval seconds.
19. sd3: SD3.5 Large (stabilityai/stable-diffusion-3.5-large's
   ``transformer/config.json``: hidden 2432, 38 heads of 64, 38 blocks,
   ``pos_embed_max_size`` 192, qk RMSNorm; 8.1B parameters) at full width, its
   file and module at ``SD3_CUT_BLOCKS`` (2) of its 38 blocks in a run of
   every phase (the write budget; the line's ``depth``), every launch count
   following the depth.  Deletes phase 14's Flux file and phase 17-18's output dirs, checks
   the free disk and what the run has written; writes with the port's writer a seeded diffusers
   transformer (8.15 GB e4m3, two shards, as phase 14's Flux file: the write
   budget), a seeded CLIP-G (bf16, full width, the first 4 of its 32 layers:
   the write budget; with the
   projection the importer leaves out) and a 16-channel VAE with both quant
   convs, beside hard links to phase 14-15's CLIP-L, T5-XXL and tokenizers
   (the tokenizer subfolders both packages read); imports the transformer
   through ``load_transformer_params`` (s, GB/s, peak host RSS and device
   GiB; every tensor bitwise the written one taken to bf16); renders 1024x1024 through
   ``CheckpointInferenceRuntime`` (``model_flavour: large-3.5``) with true CFG
   at ``validation_guidance`` 5 (two forwards per Euler step; the PNG checked,
   the latents finite, 76 flash launches per step); one full-depth denoise
   call with the kernels against the plain attention (relative L2 within
   the bound of phase 5); ``Trainer.run()`` with an int8 base
   (``quantized_matmul: full``), every block checkpointed, rank-16 LoRA, 6
   steps on four of phase 16's square JPEGs in one bucket, graphed: losses,
   s/step, MFU (``sd3_step_flops``, bench.py's convention), capture s, time
   to the first step, peak GiB, and the launches of a profiled replay, which
   must equal the capture's (76 / 38 / 38).
20. sdxl: the SDXL UNet as the JAX preset builds it (``UNetConfig.sdxl()``:
   channels 320 / 640 / 1280, transformer depths 1 / 2 / 10, cross-attention
   at all three levels where the published SDXL UNet has none at level 0,
   context 2048, added conditioning 2816; 2.58B parameters) at full width, its
   level-1 and level-2 transformer depths cut to 1 of 2 and 1 of 10 in a run of
   every phase (``SDXL_CUT_LAYERS``; (1, 2, 2) since phases 36-38, (1, 1, 1) since
   phases 39-41; the preset's depths in a run that names the phase).  Deletes phase 19's transformer and outputs; writes with
   the port's writer a seeded diffusers UNet (two shards, e4m3; bf16 in a run
   that names the phase where the writes leave room) and a 4-channel VAE beside hard links
   to phase 14's CLIP-L and tokenizer and phase 19's CLIP-G; imports the UNet
   (s, GB/s; every tensor bitwise the written one); renders 1024x1024 through
   ``CheckpointInferenceRuntime`` with true CFG at guidance 7.5, 4 steps of
   DDIM (the default) and then of UniPC (s per CFG step, peak GiB, two flash
   launches per transformer block a UNet forward: 150 at the preset's 75
   blocks, 54 at the cut's 27);
   one UNet forward with the kernels against the plain attention (relative
   L2 within phase 5's bound); ``Trainer.run()`` with a bf16 base, remat of
   every resnet and spatial transformer, rank-16 LoRA on to_q / to_k / to_v /
   to_out, AdamW 1e-4, min-SNR gamma 5 epsilon, 6 steps on four of phase 16's
   square JPEGs in one bucket, graphed: losses, s/step, MFU
   (``sdxl_step_flops``, forward x 3), time to the first step, peak GiB, and
   the launches of a profiled replay (300 / 150 / 150 at the preset's depth:
   forward, recompute, backward), which must equal the capture's, with the
   replay's top kernels;
   its UNet file is e4m3 when the run's writes would leave phases 21 and 22
   less than ``PHASE21_WRITE_GB`` + ``PHASE22_WRITE_GB``.
21. sd1x, sd2x, pixart_sigma: deletes phase 20's UNet shards and outputs,
   then for SD 1.5 (``UNetConfig.sd15()``, the JAX preset: 5 / 10 / 20 heads
   of 64 where the published UNet runs 8 heads; 1x1-conv ``proj_in`` /
   ``proj_out``; 0.86B parameters) at 512 px, SD 2.1 (``UNetConfig.sd21()``,
   0.87B, v-prediction, min-SNR gamma 5 in training) at 768 px and
   PixArt-Sigma (``PixartConfig.sigma_1024()``: 28 blocks, 1152 wide, 16
   heads of 72, T5-XXL context at 300 tokens, the 8-channel learned-range
   head; 0.61B) at 1024 px in turn: writes a seeded diffusers base as an
   e4m3 file beside hard links to phase 20's 4-channel VAE and phase 14-15's
   CLIP-L / T5-XXL and tokenizers (SD 2.1: a seeded OpenCLIP-H at full width,
   4 of its 23 layers); imports it (s, GB/s; every tensor bitwise the
   written one); renders through ``CheckpointInferenceRuntime`` with 4 DDIM
   steps under true CFG (guidance 7.5, PixArt 4.5; s per CFG step, peak GiB,
   32 / 32 / 56 flash launches per forward); one full-depth forward with the
   kernels against the plain attention (phase 5's bound); ``Trainer.run()``
   with a bf16 base, rank-16 LoRA on the attention projections, remat, AdamW
   1e-4, 6 graphed steps on four of phase 16's square JPEGs: losses, s/step,
   MFU (``sdxl_step_flops`` / ``pixart_step_flops``), time to the first
   step, peak GiB, and the launches of a profiled replay (64 / 32 / 32 for
   the UNets, 112 / 56 / 56 for PixArt), which must equal the capture's.
22. auraflow: AuraFlow v0.3 at its published width (fal/AuraFlow-v0.3's
   ``transformer/config.json``: 4 joint + 32 single blocks, hidden 3072, 12
   heads of 256, SwiGLU 8192, 8 register tokens; 6.8B parameters) at 1024
   px, at ``AURA_CUT_BLOCKS`` (1 + 2; 2 + 4 before phases 39-41) blocks in a run of every phase.  Deletes phase 21's files; checks ``auraflow_step_flops`` against
   ``torch.utils.flop_counter`` on two small configs; writes with the port's
   writer a seeded diffusers transformer (6.8 GB e4m3, two shards) and a
   seeded Pile-T5-XL (a ``umt5`` file: d_model 2048, 32 heads of 64, d_ff
   5120, gated-silu, a relative attention bias in every layer; full width,
   ``PHASE22_T5_LAYERS`` (2; 6 before phases 39-41) of its 24 blocks, bf16) beside hard links to phase 15's T5 tokenizer (as
   ``tokenizer_2``, the subfolder both packages' T5 spec reads) and phase
   20's 4-channel VAE; imports the transformer (s, GB/s; every tensor
   bitwise the written one taken to bf16); renders 1024x1024 through
   ``CheckpointInferenceRuntime`` with 4 flow Euler steps under true CFG
   (guidance 3.5; s per CFG step, peak GiB, 72 flash launches per CFG step);
   one full-depth forward with the head dim 256 kernels against the plain
   attention (phase 5's bound); ``Trainer.run()`` with an int8 base
   (``quantized_matmul: full``), every block checkpointed, rank-16 LoRA on
   to_q / to_k / to_v / to_out.0, AdamW 1e-4, 6 graphed steps on four of phase
   16's square JPEGs: losses, s/step, MFU (``auraflow_step_flops``, forward
   x 3), time to the first step, peak GiB, and the launches of a profiled
   replay (72 / 36 / 36, every one a head dim 256 instance), which must equal
   the capture's, with device ms by bucket and the idle share.
23. wan: Wan 2.1 T2V-1.3B as the JAX preset builds it (``WanConfig.b1_3()``:
   30 blocks, 1536 wide, 12 heads of 128, FFN 4 x 1536, umT5 text dim 4096;
   1.16B parameters; at ``WAN_CUT_BLOCKS`` (5; 10 before phases 36-38) blocks in a
   run of every phase) on its published 480p clip, 832 x 480 x 81 frames (21 x
   60 x 104 latents, 32,760 tokens).  Deletes phase 22's files; checks
   ``wan_step_flops`` against ``torch.utils.flop_counter`` on two small
   configs; writes with the port's writer a seeded diffusers transformer
   (1.16 GB e4m3, two shards) beside hard links to phase 15's T5-XXL (as
   ``text_encoder``, the umT5 spec's subfolder) and T5 tokenizer (as
   ``tokenizer_2``, the subfolder both packages' T5 spec reads), and two seeded
   clips as mp4 (OpenCV, mp4v) with captions; imports the transformer (s,
   GB/s; every tensor bitwise the written one taken to bf16); ``Trainer.run()``
   on the video dataset (discovery into the ``1.73x81`` bucket, the text cache
   at 512 tokens, the video VAE cache one clip per encode: s per clip and the
   stage's peak GiB), bf16 base, every block checkpointed, rank-16 LoRA on
   to_q / to_k / to_v / to_out.0, AdamW 1e-4, 6 graphed steps: losses, s/step,
   MFU (``wan_step_flops``, forward x 3), time to the first step, peak GiB, and
   the launches of a profiled replay (120 / 60 / 60), which must equal the
   capture's, with device ms by bucket and the idle share; a true-CFG render
   (guidance 5, 4 flow Euler steps) through ``CheckpointInferenceRuntime`` at
   480 px square and 81 frames (18,900 tokens), written as mp4 and read back
   (81 frames of 480 x 480): s per CFG step, the VAE decode s, peak GiB; one
   full-depth forward with the kernels against the plain attention on a
   17-frame clip (7,800 tokens; phase 5's bound); and one graphed LoRA step of
   ``i2v-14b-480p`` at its published width (5120, 40 heads of 128, 36
   channels in, 16 out) at 4 of its 40 blocks, built in memory on an int8 base
   (``quantized_matmul: full``) on the first clip's cached latents: s/step,
   peak GiB and the captured launches (16 / 8 / 8).
24. ltx: LTX-Video 0.9.5 2B as the JAX preset builds it (``LTXConfig()``: 28
   blocks, 2048 wide, 32 heads of 64, FFN 4 x 2048, T5-XXL captions at 128
   tokens; 1.92B parameters; at ``LTX_CUT_BLOCKS`` (2 since phase 46; 5 since phases 36-38; 10 before)
   blocks in a run of every phase) on 768 x 512 x 121 clips (sides multiples of
   32, 8n + 1 frames; 16 x 16 x 24 latents of 128 channels, 6,144 tokens with
   the (1, 1, 1) patch).  Deletes phase 23's files; checks ``ltx_step_flops``
   against ``torch.utils.flop_counter`` on two small configs (one per-frame);
   writes with the port's writer a seeded diffusers transformer (1.92 GB
   e4m3, two shards) beside hard links to phase 15's T5-XXL (``text_encoder``)
   and T5 tokenizer (``tokenizer_2``), and two seeded clips as mp4 with
   captions; imports the transformer (s, GB/s; every tensor bitwise the
   written one taken to bf16); ``Trainer.run()`` on the video dataset
   (discovery into the ``1.5x121`` bucket, the text cache at 128 tokens, the
   video VAE cache at LTX's config, 32x spatial and 8x temporal, one clip per
   encode: s per clip and the stage's peak GiB), bf16 base, every block
   checkpointed, rank-16 LoRA on to_q / to_k / to_v / to_out.0, AdamW 1e-4,
   the default ``ltx_i2v_prob`` (0.1), so every step takes the per-frame
   timesteps (1, 16), which the DiT's recorded calls must show; 6 graphed
   steps: losses, s/step, MFU (``ltx_step_flops``, forward x 3), time to the
   first step, peak GiB, and the launches of a profiled replay (112 / 56 /
   56), which must equal the capture's, with device ms by bucket and the idle
   share; a true-CFG render (guidance 4, 4 flow Euler steps) through
   ``CheckpointInferenceRuntime`` at 512 px square and 121 frames (4,096
   tokens), written as mp4 and read back: s per CFG step, the VAE decode s,
   peak GiB; one full-depth forward with the kernels against the plain
   attention on the training clip's 6,144 tokens (phase 5's bound); one
   graphed LoRA step of ``13b-0.9.7`` at its published width (4096, 32 heads
   of 128, cross 4096) at 4 of its 48 blocks, built in memory on an int8 base
   (``quantized_matmul: full``) on the first clip's cached latents: s/step,
   MFU, peak GiB and the captured launches (16 / 8 / 8).
25. chroma: Chroma at its published width (lodestones/Chroma's diffusers
   transformer, ``ChromaConfig()``: Flux's 19 double + 38 single blocks, 3072
   wide, 24 heads of 128, the 5 x 5120 distilled-guidance approximator over
   344 modulation slots; 8.9B parameters; at ``CHROMA_CUT_BLOCKS`` (1 + 1
   since phase 45; 1 + 2 before) blocks in a run of every phase, its kernel shapes Flux's) at 1024 px.  Deletes phase 24's
   files; checks ``chroma_step_flops`` against ``torch.utils.flop_counter`` on
   two small configs; writes with the port's writer a seeded diffusers
   transformer (1.20 GB e4m3 at the cut depth, 8.9 GB at full depth, two shards) beside hard links to phase 14's Flux
   VAE and phase 15's T5-XXL (``text_encoder``) and T5 tokenizer
   (``tokenizer_2``); imports it (s, GB/s; every tensor bitwise the written
   one taken to bf16); renders 1024x1024 through ``CheckpointInferenceRuntime``
   with 4 flow Euler steps under true CFG (guidance 4: Chroma has no guidance
   embedding; s per CFG step, peak GiB, 2 x (double + single) flash launches per CFG step); one
   full-depth forward with the kernels against the plain attention, the T5
   mask collated as the trainer collates it (phase 5's bound);
   ``Trainer.run()`` with an int8 base (``quantized_matmul: full``), every
   block checkpointed (the JAX module's ``nn.remat``, no Flux policy),
   rank-16 LoRA on Flux's ``all`` targets, the T5 padding masked, AdamW 1e-4,
   6 graphed steps on four of phase 16's square JPEGs: losses, s/step, MFU,
   time to the first step, peak GiB, and the launches of a profiled replay
   (2n / n / n for n blocks: 4 / 2 / 2 at the cut depth, 114 / 57 / 57 at
   full depth), which must equal the capture's, with device ms by bucket and
   the idle share.
26. lumina2: Lumina-Image 2.0 at the JAX preset's size (Alpha-VLLM/
   Lumina-Image-2.0's ``transformer/``, ``Lumina2Config()``: 26 joint blocks
   and 2 + 2 refiners, 2304 wide, 24 query / 8 kv heads of 96, SwiGLU 6144;
   1.97B parameters) at ``LUMINA_CUT_BLOCKS`` (3 since phase 45; 6 before) of its 26 joint blocks in a
   run of every phase (all 26 in a run that names phase 26 where the run's
   writes leave room), with its Gemma-2 2B text encoder at 1024 px.  Deletes
   phase 25's files; checks ``lumina2_step_flops`` against the flop counter
   on two small configs; writes a seeded e4m3 diffusers transformer, a seeded
   Gemma-2 2B in the HF layout (e4m3, ``gemma2_2b`` at full width: 2304 wide,
   8 heads of 256, 4 kv heads, 256,000 tokens; ``GEMMA_FILE_LAYERS`` (2) of
   its 26 layers, all 26 in a run that names phase 26 where the run's writes
   leave room) with its
   ``config.json``, a seeded Gemma-convention tokenizer that ``AutoTokenizer``
   reads (``tokenizer/``) and a hard link to phase 14's Flux VAE; encodes 16
   prompts at 256 tokens through ``LLMTextEncoder`` (prompts/s; bf16 against
   the f32 module within ``LLM_BF16_REL_L2``); imports the transformer
   (bitwise); renders 1024x1024 with true CFG (guidance 4, 4 flow Euler
   steps; 2(4 + d) flash launches per CFG step at d joint blocks: 2 over the
   256 caption tokens, 2 over 4,096 image tokens, d over 4,352 joint tokens,
   two forwards); one forward with the D = 96 kernels against the plain attention,
   the caption mask on (phase 5's bound); ``Trainer.run()`` with a bf16
   base, every block checkpointed, rank-16 LoRA on the attention projections,
   AdamW 1e-4, 6 graphed steps: losses, s/step, MFU, time to the first step,
   peak GiB, and the launches of a profiled replay (2(4 + d) / 4 + d / 4 + d,
   by shape), which must equal the capture's.
27. kandinsky5: Kandinsky 5.0 Lite, both flavours, at the JAX preset's full
   width (ai-forever/Kandinsky-5.0-T2V-Lite-sft-5s and T2I-Lite's
   ``transformer/``, ``Kandinsky5Config()``: 32 visual and 2 text blocks, 2048
   wide, 32 heads of 64, FFN 5120, 4 latent channels; 2.15B parameters), at
   ``K5_CUT_BLOCKS`` (2 since phase 46; 3 since phase 45; 6 since phases 36-38; 16 before) of its 32 visual blocks in a
   run of every phase.
   Deletes phase 26's files; checks ``kandinsky5_step_flops`` against the flop
   counter on two small configs; writes a seeded e4m3 transformer (0.48 GB at
   6 blocks, both flavours' file), the seeded Qwen2.5-VL-7B text trunk (``qwen_trunk``:
   e4m3, full width, ``QWEN_FILE_LAYERS`` (2) of its 28 layers in a run of
   every phase, a Qwen2.5-VL ``config.json`` with the text sizes at the top
   level, written once a run and linked by phases 28-29), a seeded 4-channel SD
   VAE (the image flavour's), links to phase 14's CLIP-L, phase 15's CLIP
   tokenizer in ``tokenizer/`` (both specs read it; its config names its
   class so that ``AutoTokenizer`` reads it too) and two seeded 768 x 512 x
   61 mp4 clips; encodes 16 prompts at 512 tokens through the Qwen2.5-VL
   encoder (prompts/s, bf16 against f32 within ``LLM_BF16_REL_L2``); imports
   the file through both family names (bitwise); ``kandinsky5_image`` at
   1024 px: a true-CFG flow Euler render (guidance 5; 4d + 4 flash launches a
   CFG step at d blocks: 2d self, 2d cross, 4 text), one forward against the
   plain attention (phase 5's bound), ``Trainer.run()`` with a bf16 base,
   every block checkpointed, rank-16 LoRA on the attentions' ``to_query`` /
   ``to_key`` / ``to_value`` / ``out_layer``, AdamW 1e-4, 6 graphed steps on
   four of phase 16's JPEGs (4d + 4 / 2d + 2 / 2d + 2 launches, by shape);
   ``kandinsky5_video`` on the clips (the ``1.5x61`` bucket, the video VAE
   cache at the Wan config and 4 latents: 16 x 64 x 96 latents, 24,576
   tokens): 6 graphed steps as above, a true-CFG mp4 render at 512 px square
   and 61 frames (16,384 tokens), the parity forward on a 17-frame
   clip (7,680 tokens); each run's s/step, MFU, time to the first step, peak
   GiB, and a profiled replay's launches held to the capture's.
28. hunyuanvideo: HunyuanVideo 1.5 t2v-480p at the JAX preset's full width
   (tencent/HunyuanVideo-1.5's ``transformer/``, ``HunyuanVideo15Config()``: 54
   dual-stream and 2 refiner blocks, 2048 wide, 16 heads of 128, 65 channels
   in; 8.33B parameters), at ``HY_CUT_BLOCKS`` (3 since phase 45; 6 before) of its 54 blocks in a run
   of every phase.  Deletes phase 27's files (not the Qwen trunk); checks
   ``hunyuanvideo_step_flops`` against the flop counter on two small configs;
   writes a seeded e4m3 diffusers transformer, a seeded ByT5-small in the T5
   layout (google/byt5-small's sizes, bf16) with a byte-level tokenizer in
   ByT5's ids (``tokenizer_2``, read through ``T5TokenizerFast``), a
   Qwen-convention tokenizer (``tokenizer/``), the Qwen trunk linked, and two
   seeded 848 x 480 x 17 mp4 clips; encodes 16 prompts at 256 tokens
   (prompts/s); imports the transformer (bitwise); ``Trainer.run()`` on the
   clips (the ``1.77x17`` bucket, the video VAE at 32 latents: 5 x 60 x 106
   latents, 31,800 video tokens and 333 caption tokens in the joint
   sequence, both masks), bf16 base, every dual-stream block checkpointed,
   rank-16 LoRA on ``img_attn_q/k/v/proj``, 6 graphed steps: s/step, MFU,
   time to the first step, peak GiB, and a profiled replay's launches (2d +
   2 / d / d at d blocks: the refiner's two attentions run once and have no
   backward), by shape; a true-CFG mp4 render at 480 px square and 17 frames;
   one forward against the plain attention on a 5-frame clip with padded
   captions (the -1 pads in the refiner and the joint layers; phase 5's
   bound).
29. qwen_image: Qwen-Image at the JAX preset's full width (Qwen/Qwen-Image's
   ``transformer/``, ``QwenImageConfig()``: 60 double-stream blocks, 3072 wide,
   24 heads of 128, 64 packed channels in; 20.4B parameters), at
   ``QI_CUT_BLOCKS`` (1 since phase 45; 2 before) of its 60 blocks in a run of every phase.  Deletes
   phase 28's files; checks ``qwen_image_step_flops`` against the flop counter
   on two small configs; writes a seeded e4m3 diffusers transformer, links
   phase 27's Qwen2.5-VL trunk (written here when phase 27 did not run) and
   phase 14's Flux VAE, writes a Qwen-convention tokenizer; encodes 16 prompts
   at 1024 tokens (prompts/s, bf16 against f32); imports the transformer
   (bitwise, a tensor at a time); a 1024 px true-CFG flow Euler render
   (guidance 4; 2d launches a CFG step over the 5,120 joint tokens: the
   1,024 Qwen tokens unmasked, as the JAX family collates them); one forward
   against the plain attention (phase 5's bound); ``Trainer.run()`` on an
   int8 base (``quantized_matmul: full``), every block checkpointed, rank-16
   LoRA on every adapter-carrying linear (the JAX family's default), 6
   graphed steps on four of phase 16's JPEGs: s/step, MFU, time to the first
   step, peak GiB, a replay and an eager step from one state bitwise equal,
   and a profiled replay's launches (2d / d / d, by shape) held to the
   capture's.  Then Z-Image (Tongyi-MAI/Z-Image-Turbo as the JAX family
   builds it: the same DiT without text rope, 19 blocks, 2560-wide Qwen
   features at 4,096 tokens) at ``ZI_CUT_BLOCKS`` (2) blocks built in memory,
   with a seeded 2560-wide qwen2-layout trunk (the JAX ``qwen2.5`` spec at
   Qwen3-4B's sizes, ``ZI_TRUNK_LAYERS`` of 36 layers) and the tokenizer: the
   parity forward over 8,192 joint tokens and 6 graphed LoRA steps as above.
   MageFlow does not run: its published arch reads 32 latent channels and its
   trainer builds the 16-channel Flux VAE (ROADMAP Queue 3).
30. hidream: HiDream-I1 at the JAX preset's full width (HiDream-ai/
   HiDream-I1-Full's ``transformer/``, ``HiDreamConfig()``: 16 double and 32
   single blocks, 20 heads of 128, 4 experts top-2 with a shared expert, FFN
   6912; 17.1B parameters), at ``HD_CUT_BLOCKS`` (1 + 1) in a run of every
   phase.  Deletes phase 29's files; checks ``hidream_step_flops`` against
   the flop counter on two small configs; writes a seeded e4m3 transformer
   (the adaLN drawn) and a seeded Llama-3.1-8B trunk (``llama3_8b`` at full
   width, ``LLAMA_FILE_LAYERS`` (2) of its 32 layers, a Llama-3.1
   ``config.json``) beside links to phase 14's CLIP-L, phase 19's CLIP-G,
   phase 15's T5-XXL and T5 tokenizer (``tokenizer_2``) and Flux VAE, and
   phase 15's CLIP tokenizer in ``tokenizer/`` (the CLIP and Llama specs read
   it); encodes 16 prompts at 128 tokens through the Llama encoder
   (prompts/s, bf16 against f32); imports the transformer (bitwise); a 1024
   px true-CFG render (guidance 5; 2(d + s) launches a CFG step over 4,480
   joint tokens); one forward against the plain attention; ``Trainer.run()``
   as phase 29's with ``hidream_use_load_balancing_loss``: ``moe_gate_loss``
   logged at every step, a replay's loss, grad norm and ``moe_gate_loss``
   bitwise an eager step's, the profiled replay's launches held to the
   capture's.
31. flux2: FLUX.2-dev at the JAX preset's full width (black-forest-labs/
   FLUX.2-dev's ``transformer/``, ``Flux2Config()``: 8 double and 48 single
   blocks, 6144 wide, 48 heads of 128, 32 latent channels, global modulation,
   guidance embedding; 32.2B parameters), at ``F2_CUT_BLOCKS`` (1 + 1) in a
   run of every phase.  Deletes phase 30's files; checks ``flux2_step_flops``
   against the flop counter on two small configs; writes a seeded e4m3
   diffusers transformer (2.29 GB at 1 + 1) and a word-level tokenizer;
   builds a seeded Mistral-3 24B trunk (``mistral3_24b``: 5120 wide, 32 heads
   and 8 kv heads of 128, FFN 32,768, 131,072 tokens, rope theta 1e8) at
   ``MISTRAL_LAYERS`` (2) of its 40 layers in memory (its loader is held on
   the CPU) and encodes 16 prompts at 512 tokens with three taps through
   ``Flux2.encode_text`` (15,360 features; prompts/s, bf16 against f32);
   imports the transformer (bitwise); one forward against the plain attention
   over 4,096 image and 512 text tokens (4,608 joint, unmasked, as the JAX
   family collates them) at 1024 px; the guidance-distilled flow Euler loop
   (one forward a step, guidance 4) over 32-channel latents, without the
   decode (the trainer builds the 16-channel Flux VAE for every family of 16
   channels or more, as the JAX trainer does, so no VAE here decodes FLUX.2's
   latents: ROADMAP Queue 3); 6 graphed rank-16 LoRA steps on an int8 base
   (``quantized_matmul: full``), every block checkpointed, through
   ``build_train_step`` / ``jit_train_step`` (``Trainer.run()`` stops at the
   same wall): replays bitwise equal to eager steps, s/step, MFU, peak GiB and
   a profiled replay's launches (2(d + s) / d + s / d + s) held to the
   capture's.  Then the ``klein`` width (24 heads, 5 + 20 blocks, no
   guidance) at 1 + 1 blocks built in memory: one parity forward and 2
   graphed steps.  A run that names the phase (``--phases 31``) also builds
   all 8 + 48 blocks in memory (an int8 base of 32 GB, nothing written) and
   times their 6 graphed steps.
32. kolors: Kolors at the JAX preset's full width (Kwai-Kolors/
   Kolors-diffusers' ``unet/`` as the JAX family builds it: SDXL's UNet with
   a 4,096-wide cross-attention and ``addition_embed_dim`` 5,632; 2.94B
   parameters), with its level-2 transformer depth cut to ``KOLORS_CUT_LAYERS``
   ((1, 2, 2) of (1, 2, 10)) in a run of every phase.  Deletes phase 31's
   files; writes a seeded e4m3 diffusers UNet and a seeded ChatGLM3-6B trunk
   (``chatglm3_6b``: 4096 wide, 32 heads of 128 and 2 kv groups, fused
   ``query_key_value`` with biases, FFN 13,696, 65,024 tokens) at
   ``GLM_FILE_LAYERS`` (1; 2 before phases 39-41) of its 28 layers with ChatGLM's own
   ``config.json`` keys, a word-level tokenizer, and links phase 20's SDXL VAE
   (or writes a seeded one); encodes 16 prompts at 256 tokens through the
   ChatGLM encoder (prompts/s, bf16 against f32); imports the UNet (bitwise);
   a 1024 px true-CFG DDIM render (guidance 5) through the checkpoint runtime
   (the ChatGLM states unmasked, the pooled vector the last valid token's);
   one UNet forward against the plain attention; ``Trainer.run()`` with a
   bf16 base, rank-16 LoRA on the attention projections, every resnet and
   spatial transformer checkpointed and min-SNR epsilon: 6 graphed steps on
   four of phase 16's JPEGs, s/step, MFU, a replay and an eager step bitwise
   equal and a profiled replay's launches by shape held to the capture's.
33. longcat_image: LongCat-Image at the JAX preset's full width
   (meituan-longcat/LongCat-Image's ``transformer/`` as ``LongcatImage``
   builds it: Flux's 19 double and 38 single blocks, 3072 wide, 24 heads of
   128, 3584-wide Qwen text, no pooled or guidance embedder; 11.9B
   parameters) at ``LC_CUT_BLOCKS`` (1 + 1) in a run of every phase.
   Deletes phase 32's files; checks ``longcat_image_step_flops`` against the
   flop counter on two small configs; writes a seeded e4m3 transformer in
   LongCat's layout (``time_embed.``) and a word-level tokenizer, links the
   Qwen2.5-VL-7B trunk (``qwen_trunk``, 2 of 28 layers) and phase 14's Flux
   VAE; encodes 16 prompts through ``LongcatImage.encode_text`` (the
   captioning template around each, its 40 + 8 token spans sliced off: 464
   of 512 tokens; prompts/s, bf16 against f32); imports the transformer
   (bitwise); a 1024 px true-CFG flow Euler render (guidance 4) over 4,096
   image tokens after 464 text tokens at the sliding ids; one forward against
   the plain attention; ``Trainer.run()`` on an int8 base, every block
   checkpointed, rank 16: 6 graphed steps on four of phase 16's JPEGs; then
   the ``edit`` flavour on the same file: ``build_train_step`` graphed on
   seeded ``control_latents`` (4,096 reference tokens at modality 2 and t = 0:
   8,656 joint tokens, tokenwise timesteps), the replays held to the eager
   steps (bitwise where two eager runs are).
34. z_image_omni: Z-Image-Omni at the JAX preset's full width
   (Tongyi-MAI/Z-Image-Omni's ``transformer/``, ``ZImageOmniConfig()``: 30
   layers and 2 + 2 + 2 refiners, 3840 wide, 30 heads of 128, scale-only
   adaLN with tanh gates, RoPE theta 256 over (32, 48, 48); 6.51B
   parameters) at ``ZO_CUT_BLOCKS`` (1 layer, 1 + 1 + 1 refiners) in a run
   of every phase.  Checks ``z_image_omni_step_flops`` against the flop
   counter; writes a seeded e4m3 transformer (the ``"2-1"`` patch keys and
   the SigLIP modules) and a word-level tokenizer, links phase 29's
   2560-wide qwen2 trunk (2 layers; written here in a run without phase 29)
   and phase 14's Flux VAE; encodes 16 prompts at 512 tokens (prompts/s,
   bf16 against f32); imports the transformer (bitwise); a 1024 px
   true-CFG render (the caption mask on, 512 + 4,096 joint tokens with
   segment ids all 1, the refiners over 4,096 and 512); ``Trainer.run()`` as
   phase 33's, text to image; one forward with seeded ``control_latents`` and
   a 32 x 32 grid of ``siglip_embeds`` (512 + 4,096 + 4,096 + 1,024 joint
   tokens, each token's modulation the noisy or the clean one) against the
   plain attention.  Then Boogu-Image, built through the registry by name at
   2 of its 26 blocks in memory (Lumina2's layout and width): one forward
   against the plain attention.
35. zlab_i1: Zlab-i1 at the JAX preset's full width (zlab-princeton/i1-3B's
   ``transformer/``, ``ZlabI1Config()``: 2016 wide, 28 heads of 72 zero-padded
   to 128 by the wrappers, 14 in, 1 mid and 14 out U-ViT blocks, 32 latent
   channels; 3.17B parameters).  Checks ``zlab_i1_step_flops`` against the
   flop counter; writes a seeded e4m3 checkpoint at ``ZL_FILE_BLOCKS`` (3:
   1 in, the mid, 1 out) of 29 and imports it (bitwise); builds a seeded
   Gemma-2 2B at 2 of its 26 layers in memory with a word-level tokenizer
   and encodes 16 prompts at 256 tokens (prompts/s); builds blocks in memory
   (all 29 in a run that names the phase, ``ZL_MEMORY_BLOCKS`` (5: 2 in, the
   mid, 2 out) in a run of every phase): one forward against the plain
   attention over 4,096 image and 256
   masked text tokens (query segment ids 1, key ids the text mask), the flow
   Euler loop without a decode (no VAE of either package decodes FLUX.2's 32
   channels: ROADMAP Queue 3), and ``build_train_step`` graphed on seeded
   32-channel latents (normalized by the FLUX.2 statistics): 6 replays held
   to the eager steps, s/step, MFU, peak GiB and the profiled replay's
   launches.
36. krea2: Krea-2 at the JAX preset's full width (krea/krea-2's
   ``transformer/``, ``Krea2Config()``: 6144 wide, 48 query and 12 key/value
   heads of 128 with sigmoid output gates, SwiGLU 16,384, 28 blocks, a
   2560-wide text fusion of 2 layerwise and 2 refiner blocks over 12 taps;
   12.82B parameters).  Checks ``krea2_flops`` against the flop counter;
   writes a seeded e4m3 checkpoint at ``K2_FILE_BLOCKS`` (1) of its 28 blocks
   with the four fusion blocks, links phase 29's 2560-wide qwen2 trunk (written
   here in a run without phase 29) and phase 14's Flux VAE, writes a
   word-level tokenizer; encodes 16 prompts at 512 tokens (prompts/s, bf16
   against f32) and a caption through ``Krea2.encode_text`` (12 taps spread
   over the trunk's 3 states); imports the transformer (bitwise); a 1024 px
   true-CFG render (unmasked, as in JAX); one forward with the caption mask
   as key ids against the plain attention, and the layerwise attention's plain
   version timed beside the kernel; ``Trainer.run()`` on an int8 base, every
   block checkpointed, rank 16: 6 graphed steps; the edit step
   (``krea2_reference_latents``: 4,096 reference tokens more, 8,704 joint)
   through ``build_train_step``; in a run that names it, all 28 blocks built
   in memory (12.8 GB of int8) and their graphed step timed.
37. cosmos: Cosmos-Predict2 2B at the JAX preset's full width
   (nvidia/Cosmos-Predict2-2B-Text2Image's ``transformer/``,
   ``Cosmos1Config.predict2_2b()``: 2048 wide, 16 heads of 128, 28 blocks,
   AdaLN-LoRA 256; 1.96B parameters) at ``CO_FILE_BLOCKS`` (4).  Deletes phase
   36's files; checks ``cosmos_flops``; writes a seeded e4m3 checkpoint and a
   seeded T5-11B encoder (1024 wide, 128 heads of 128, relu FFN 65,536) at
   ``T5_11B_LAYERS`` (1) of its 24 blocks, links phase 15's T5 tokenizer (in
   ``tokenizer_2``, where the T5 spec reads it) and phase 14's Flux VAE;
   encodes 16 prompts at 512 tokens (the states past the mask zeroed);
   imports (bitwise); a 1024 px true-CFG render down the EDM Euler ladder
   (Karras rho 7 from 80 to 0.002, x0 predictions); one forward against the
   plain attention; ``Trainer.run()`` on an int8 base: 6 graphed EDM steps
   (log-normal sigma drawn through ``erfinv`` inside the graph, the (sigma^2 +
   1) / sigma^2 weighted x0 loss); then the 14B width (40 heads of 128) at
   ``CO14B_BLOCKS`` (2) of its 36 blocks in memory: a forward against the
   plain attention and its graphed step.
38. anima: Anima at the JAX preset's full width (circulus/anima's
   ``transformer/``, ``AnimaConfig()``: the 6-layer, 1024-wide LLM adapter
   over 32,128 T5 ids on the 2B Cosmos core; 2.09B parameters), the whole
   adapter and ``AN_FILE_BLOCKS`` (4) of the core's 28 blocks.  Deletes phase
   37's files; checks ``anima_flops``; writes a seeded e4m3 checkpoint and a
   seeded Qwen3-0.6B trunk (1024 wide, in the qwen2 layout) at
   ``QWEN3_06B_LAYERS`` (2) of its 28 layers, one word-level tokenizer in
   ``tokenizer/`` that both the Qwen encoder and the T5 ids read (as in the
   JAX package), links phase 14's Flux VAE; encodes 16 prompts at 256 tokens
   and a caption's 64 T5 ids; imports (bitwise); a 1024 px true-CFG flow
   render; one forward against the plain attention (the adapter's attentions
   run the plain version, timed beside the kernel); ``Trainer.run()`` on an
   int8 base: 6 graphed steps.
39. omnigen: OmniGen at the JAX preset's full width (Shitao/OmniGen-v1-diffusers'
   ``transformer/``, ``OmniGenConfig()``: a 3072-wide Phi-3 decoder, 32 heads
   of 96 (query and key/value), 32 layers, the fused gate_up SwiGLU, a 32,064-row
   token table; 3.76B parameters).  Deletes phase 38's files; checks
   ``omnigen_flops`` against the flop counter; writes a seeded e4m3 checkpoint
   at ``OG_FILE_BLOCKS`` (2) of its 32 layers, a seeded word-level tokenizer at
   Phi-3's 32,064 ids (``write_phi3_tokenizer``) and a 4-channel SD VAE (phase
   20's linked where it is still on disk); tokenises 16 prompts and a caption
   through ``OmniGen.encode_text`` (no text encoder: int32 ids and a float
   mask at 120 tokens); imports (bitwise); a 1024 px true-CFG render (the
   4,096 image rows of each layer through the kernels against all 4,217 keys
   at head dim 96 zero-padded to 128, the 121 prefix rows a plain causal
   block); one forward against the plain attention, right- and left-padded;
   ``Trainer.run()`` on an int8 base (the SD VAE, the ids in the text cache):
   6 graphed steps; in a run that names it, all 32 layers built in memory
   and their graphed step timed.
40. ernie: ERNIE-Image at the JAX preset's full width (baidu/ERNIE-4.5-VL-image's
   ``transformer/``, ``ErnieConfig()``: 3072 wide, 24 heads of 128, 24 layers,
   FFN 8192, 128 packed channels, a 2560 -> 3072 ``text_proj``; 2.82B
   parameters).  Deletes phase 39's files; checks ``ernie_flops``; writes a
   seeded e4m3 checkpoint at ``ER_FILE_BLOCKS`` (2) of 24 (its zero-init AdaLN
   and final linear drawn), links phase 29's 2560-wide qwen2 trunk (kept by
   phase 36; written here in a run without it), writes a word-level tokenizer;
   encodes 16 prompts at 512 tokens through the ``qwen2.5`` spec (prompts/s,
   bf16 against f32); imports (bitwise); one forward against the plain
   attention over [4,096 image | 512 text] with the text lengths as key ids;
   the flow Euler loop with true CFG over 32-channel latents, without a
   decode; 6 graphed LoRA steps on an int8 base through ``build_train_step``
   (the 32-channel wall stops ``Trainer.run()`` in both packages); in a run
   that names it, all 24 layers in memory.
41. ideogram: Ideogram at the JAX preset's full width (ideogram-ai/ideogram-v3-fp8's
   ``transformer/``, ``IdeogramConfig()``: 4608 wide, 18 heads of 256, 34
   layers, FFN 12,288, 13 taps of a 4096-wide trunk, 53,248 features; 9.28B
   parameters).  Deletes phase 40's files; checks ``ideogram_flops``; writes a
   seeded e4m3 checkpoint at ``ID_FILE_BLOCKS`` (1) of 34 with the whole
   ``llm_cond_proj`` and a word-level tokenizer; builds a seeded 4096-wide
   qwen2-layout trunk (Qwen3-VL-8B's text sizes) at ``ID_TRUNK_LAYERS`` (2) of
   36 in memory, encodes 16 prompts at 512 tokens (prompts/s, bf16 against
   f32) and a caption through ``Ideogram.encode_text`` (the auto-json caption,
   13 taps spread over 3 states); the enhancer's greedy loop for
   ``ID_UPSAMPLE_TOKENS`` tokens on a seeded 151,936 x 4096 head held on the
   card; imports (bitwise); one forward against the plain attention at head
   dim 256 (the text mask as segment ids, pads at 0); the CFG sampler loop
   without a decode; 6 graphed LoRA steps through ``build_train_step``; in a
   run that names it, all 34 layers in memory (9.2 GB of int8).
42. longcat_video: LongCat-Video at the JAX preset's full width
   (meituan-longcat/LongCat-Video, ``LongCatVideoConfig()``: 4096 wide, 32
   heads of 128, 48 blocks, SwiGLU 11,008; 13.58B parameters).  Checks
   ``longcat_video_flops``; writes a seeded e4m3 checkpoint at
   ``LV_FILE_BLOCKS`` (2) of 48 and two seeded 832 x 480 x 81 clips, links
   phase 15's T5-XXL and tokenizer; imports (bitwise); ``Trainer.run()``:
   the T5 text cache at 512 tokens with the mask, the Wan-config video VAE
   cache (21 x 60 x 104 x 16 latents: 32,760 tokens), 6 graphed rank-16
   LoRA steps on an int8 base (``quantized_matmul`` full) with every block
   checkpointed, a replay bitwise against an eager step and the profiled
   replay's launches by shape (the self-attention over the clip and the
   cross-attention against the T5 keys with query ids 1 and key ids 1 / -1);
   a true-CFG mp4 render at 480 px square and 17 frames; one forward against
   the plain attention on a 17-frame clip (7,800 tokens); in a run that
   names it, all 48 blocks in memory (13.6 GB of int8) and their graphed
   step.
43. sana: Sana 1600M at the JAX preset's full width
   (Efficient-Large-Model/Sana_1600M_1024px_diffusers' ``transformer/``,
   ``SanaConfig()``: 2240 wide, 20 blocks, 70 linear heads of 32, 20 cross
   heads of 112, Mix-FFN 5600, 32 latent channels; 1.60B parameters).
   Checks ``sana_flops``; writes a seeded e4m3 checkpoint at
   ``SA_FILE_BLOCKS`` (4) of 20, a seeded Gemma-2 2B at ``GEMMA_FILE_LAYERS``
   (2) of 26 (e4m3) and a word-level tokenizer; encodes 16 prompts at 300
   tokens through the ``gemma`` spec; imports (bitwise); one forward against
   the plain attention (the unmasked cross-attention at head dim 112, 1,024
   queries against 300 keys); the CFG sampler loop at 1024 px without a
   decode; 6 graphed LoRA steps through ``build_train_step`` (the
   32-channel wall); the linear attention's time per block at full width;
   in a run that names it, all 20 blocks in memory.
44. sanavideo: Sana-Video 2B at the JAX preset's full width
   (Efficient-Large-Model/SANA-Video_2B_480p, ``SanaVideoConfig()``: 20
   heads of 112, 2240 wide, 20 blocks, GLUMBTempConv 5600; 1.91B
   parameters).  Checks ``sanavideo_flops``; writes a seeded e4m3
   checkpoint at ``SV_FILE_BLOCKS`` (4) of 20, links phase 43's Gemma-2 and
   tokenizer and phase 42's clips with their cached latents (each written
   here in a run without them); then as phase 42, the cross-attention
   against 300 Gemma keys with the mask as key ids, and the linear
   attention's time per block at full width; in a run that names it, all
   20 blocks in memory.
45. cosmos3: the Cosmos3 omni MoT at the JAX preset's full width
   (``Cosmos3Config()``: a Qwen3-VL backbone run as a Mixture of
   Transformers, 4096 wide, 36 layers of two pathways, 32 query and 8 kv
   heads of 128, SwiGLU 12,288, a 151,936-row token table and ``lm_head``,
   48 latent channels in 2 x 2 patches; 15.16B parameters).  Checks
   ``cosmos3_flops``; writes a seeded e4m3 checkpoint in the flat layout at
   ``C3_FILE_LAYERS`` (1 since phase 46; 2 before) of 36 with the whole table and head, and a
   word-level tokenizer at the model dir's root; encodes 16 prompts at 64
   ids through ``AutoTokenizer`` (prompts/s); imports (bitwise) and reads the
   reasoner's parameters from the same file (bitwise the MoT's
   understanding pathway); one forward against the plain attention on a
   17-frame clip (5 latent frames: 4,400 generation tokens); the reasoner
   over the same 64 ids and the generator-only replay held bitwise to the
   full MoT forward; the true-CFG flow Euler loop over a 1280 x 704 x 93
   clip's latents (24 x 44 x 80 x 48: 21,120 generation tokens against 21,184
   keys) without a decode, the empty prompt's ids as the negative; 6 graphed
   rank-16 LoRA steps on ``attn_gen_q/k/v/out`` on an int8 base
   (``quantized_matmul`` full, every layer checkpointed) through
   ``build_train_step``, a replay bitwise against an eager step and the
   profiled replay's launches by shape; the AVAE audio tokenizer at its
   shipped config (496M parameters drawn on the card): 10 s of 48 kHz stereo
   encoded (250 latent frames of 64) and decoded, s and s of audio per s, a
   1 s excerpt held against the same module in float64 on the CPU; in a run
   that names it, all 36 layers in memory (15 GB of int8) and their graphed
   step.
46. ltxvideo2: LTX-2 at the JAX preset's full width (``LTX2Config()``: 48
   dual-modal blocks, a 4096-wide video stream of 32 heads of 128 and a
   2048-wide audio stream of 32 heads of 64, six attentions a block, 128
   latent channels per stream, 3840-wide caption features; 18.88B
   parameters).  Checks ``ltx2_flops`` against the flop counter on two small
   configs (one tokenwise); writes a seeded e4m3 diffusers transformer at
   ``LTX2_FILE_BLOCKS`` (1) of 48 blocks with every parameter outside them
   (0.73 GB) and a seeded e4m3 latent upsampler at its published config
   (0.13 GB, the config in the file's metadata) beside hard links to phase
   43's Gemma-2 and tokenizer (written here in a run without phase 43), and
   to phase 24's two seeded 768 x 512 x 121 clips (16 x 16 x 24 latents:
   6,144 video tokens); imports (bitwise); ``Trainer.run()``: the text cache at 256
   tokens, the video VAE cache at the family's 128-channel config, 6
   graphed rank-16 LoRA steps on a bf16 base with every block checkpointed
   and the first frame held clean (tokenwise (1, 6144) timesteps at every
   DiT call), a replay bitwise against an eager step, the profiled replay's
   launches by shape; the joint audiovisual step: 6 graphed steps through
   ``build_train_step`` on an int8 base with 121 audio latent tokens and the
   caption mask (180 of 256 valid), replays against eager steps,
   ``audio_loss``; 16 prompts encoded (prompts/s); the trained-stage
   true-CFG render and the spatial-upscale render through the upsampler
   file, both at 768 px square and 25 frames, decoded to mp4 and read back;
   one forward against the plain attention on 25 frames (1,536 video and 25
   audio tokens); the Gemma connectors at their published config (1.43B
   parameters built in memory, bf16) on left-padded stacked features (1,
   256, 3840 x 49) with 180 valid, against the plain attention; in a run that
   names it, all 48 blocks in memory on an int8 base (about 19 GB) and their
   graphed joint step;
47. ace_step: ACE-Step's transformer at the JAX preset's full width
   (``ACEStepConfig()``: 28 Lite-LA blocks 1536 wide, 24 heads of 64,
   GLUMBConv 6,144, the 6-layer 1024-wide conformer over the 6,681-token
   lyric table, the two SSL heads; 8-channel latents of the stereo 44.1 kHz
   audio VAE, ``AudioVAEConfig.ace()``).  Checks ``acestep_flops`` against the
   flop counter on two small configs; writes a seeded e4m3 diffusers
   transformer at ``ACE_FILE_BLOCKS`` (2) of 28 blocks with the conformer and
   conditioning whole, a seeded umT5 at umT5-base's 768 width
   (``UMT5_LAYERS`` of 12 layers) beside phase 15's T5 tokenizer, a seeded BPE
   ``lyrics_utils/vocab.json`` and four seeded stereo 16-bit WAVs of 47 s at
   44.1 kHz (2,072,700 samples, 4,048 latents, the mel layout 16 x 253) with
   captions and ``.lyrics.txt`` sidecars; imports (bitwise); ``Trainer.run()``:
   audio discovery into the ``47s`` bucket, the text cache at 256 tokens, the
   audio VAE cache (s per clip, the stage's peak), 6 graphed rank-16 LoRA
   steps on the default preset with the lyric ids of the sidecars in every
   batch (the cross-attention over 1 + 256 + 128 keys, 363 valid), a replay
   bitwise against an eager step and the profiled replay's launches by shape;
   the true-CFG render of 47 s with ``validation_lyrics`` through
   ``CheckpointInferenceRuntime``, its WAV read back as (2,072,576, 2) int16
   (the decode of 4,048 latents x 512: the render keeps whole latents);
   one forward against the plain attention; the audio VAE encoder's four
   strided convs on one clip through ``conv1d`` (the card's path) against
   ``unfolded_conv`` (the CPU's bf16 path): ms each and their rel L2; in a
   run that names it, all 28 blocks in memory on an int8 base and their
   graphed step;
48. wan_s2v: Wan-S2V at the ``s2v-14b`` width (``WanConfig.b14()``: 5120, 40
   heads of 128).  Writes a seeded e4m3 file in Wan's layout at
   ``S2V_FILE_BLOCKS`` (1) of 40 blocks beside hard links to phase 15's T5-XXL
   and tokenizer, and to phase 42's two 832 x 480 x 81 clips and their video
   latents (written here in a run without phase 42), each with a seeded
   same-stem 16 kHz WAV; imports through ``load_wan_params`` (bitwise);
   ``Trainer.run()`` on a dataset with ``audio: {pair_with_video: true}``: 6
   graphed rank-16 LoRA steps whose cross-attention runs over 512 text and
   128 audio-feature keys, the collated ``audio_embeds`` equal to a host
   recomputation from the clip's WAV, a replay bitwise against an eager step
   and the profiled replay's launches by shape; the text-only true-CFG render
   (17 frames at 480 px square) through ``CheckpointInferenceRuntime``; one
   forward with audio features against the plain attention on 17 frames;
   last, the run's writes against ``RUN_WRITE_LIMIT_GB`` less
   ``RUN_WRITE_MARGIN_GB``.

Phases 14-16 print before phase 4, which renders from phase 15's encoders;
their Flux, CLIP-L, T5-XXL, VAE and tokenizer files stay on disk for phases 17-32.
Phases 3 and 7 also run head dims 72, 96 and 112 (pixart, lumina2, sana),
which the wrappers zero-pad to 128, masked and unmasked, the shapes
phase 21 meets first (``PHASE21_KERNEL_CASES``: PixArt's (1, 16, 4096, 72)
self-attention and its 300 T5 keys, with the kernel at D = 128 on the same
shape beside them; SD 2.1's 576- and 9216-token levels; SD 1.5's 256), and
the head dim 256 instances (``D256_CASES``: AuraFlow's (1, 12, 4360, 256)
with no caller mask, 4096 tokens unmasked, packed samples, D = 192 padded
to 256, and phase 7's cross case at D = 256; dq bitwise over two launches
at AuraFlow's shape; kernel, plain and SDPA times and bounds), and Wan's
shapes (``WAN_KERNEL_CASES``: the (1, 12, 32760, 128) self-attention with
its ragged tail, the same queries against 512 keys, and the 14B's (1, 40,
32760, 128); each held against the plain version at 2 heads, one head at a
time, and timed at its full head count beside the plain version head by
head, SDPA's fastest fused backend and the bound; the inputs drawn on the
card), and LTX's (``LTX_KERNEL_CASES``: the 2B's (1, 32, 6144, 64)
self-attention, 48 full tiles, the same queries against 128 T5 keys, one key
tile, and the 13B's (1, 32, 6144, 128); held against the plain version at
every head, one head at a time), and Lumina2's (``LUMINA_KERNEL_CASES``: 24
heads of 96 over the joint 4,352 tokens with a caption-mask segment plane,
180 of 256 caption tokens valid and the pads at 0, the noise refiners'
4,096 image tokens unmasked and the context refiners' 256 caption tokens
masked; held at every head, the bound reckoned at D = 96 over the attended
pairs, SDPA with the boolean mask), and Kandinsky 5.0's (``K5_KERNEL_CASES``:
the video self-attention (1, 32, 24576, 64) and its 512 Qwen keys, unmasked)
and HunyuanVideo's (``HY_KERNEL_CASES``: the joint (1, 16, 32133, 128) with
the segment plane the DiT makes, 180 of 256 Qwen and 40 of 77 ByT5 tokens
valid and the pads at -1, and the refiner's 256 tokens, 180 valid), each held
at 2 heads, and Qwen-Image's, Z-Image's and HiDream's (``QI_KERNEL_CASES``,
``HD_KERNEL_CASES``: the joint (1, 24, 5120, 128) and (1, 24, 8192, 128) and
(1, 20, 4480, 128), unmasked), held at 2 heads, and FLUX.2's and Kolors's
(``F2_KERNEL_CASES``: the joint (1, 48, 4608, 128), unmasked; the klein
width's 24 heads share Flux's kernel instance; ``KOLORS_KERNEL_CASES``: the
UNet's self-attention at its three levels and their cross-attention against
256 ChatGLM keys, D = 64, unmasked), and LongCat-Image's, Z-Image-Omni's and
Zlab-i1's (``LC_KERNEL_CASES``: the joint (1, 24, 4560, 128) and the edit
flavour's (1, 24, 8656, 128), unmasked; ``ZO_KERNEL_CASES``: the joint
(1, 30, 4608, 128) and the omni forward's (1, 30, 9728, 128) with segment ids
all 1, the noise refiner's 4,096 and the context refiner's 512 tokens,
unmasked; ``ZL_KERNEL_CASES``: the joint (1, 28, 4352, 72) with query ids 1
and key ids the text mask (180 of 256 valid), the connector's 256 tokens
unmasked), held at 2 heads, and Krea-2's and Cosmos's (``K2_KERNEL_CASES``:
the joint (1, 48, 4608, 128) and the edit's (1, 48, 8704, 128), K and V
repeated from a quarter of the heads as ``jnp.repeat`` does, query ids 1 and
the text mask (300 of 512 valid) as key ids, held at 4 heads over one
key/value head; the refiner's (1, 20, 512, 128), masked alike;
``CO_KERNEL_CASES``: the 2B's self-attention (1, 16, 4096, 128) and its cross
against 512 T5 keys, the 14B's at 40 heads, unmasked, held at 2 heads;
Anima's core has the 2B's shapes), and OmniGen's, ERNIE's and Ideogram's
(``OG_KERNEL_CASES``: the image rows (1, 32, 4096 queries, 4217 keys, 96),
query ids 1 and key ids 1 / -1 with 77 of 120 prompt keys valid, beside the
plain prefix block's time (``omnigen_prefix_block``); ``ER_KERNEL_CASES``:
the joint (1, 24, 4608, 128) with 300 of 512 text keys valid;
``ID_KERNEL_CASES``: the joint (1, 18, 4608, 256), the text mask as the
segment ids of both sides), held at 2 heads, and LongCat-Video's, Sana's and
Sana-Video's (``LV_KERNEL_CASES``: the self-attention (1, 32, 32760, 128)
with its ragged tail and the cross-attention against 512 T5 keys, query ids
1 and key ids 1 / -1 with 300 valid; ``SA_KERNEL_CASES``: the unmasked
cross-attention (1, 20, 1024 queries, 300 keys, 112); ``SV_KERNEL_CASES``:
the cross-attention (1, 20, 32760 queries, 300 keys, 112) with 120 keys
valid), held at 2 heads, and Cosmos3's (``COSMOS3_KERNEL_CASES``: the
generation attention (1, 32, 21120 queries, 21184 keys, 128), unmasked, K
and V repeated from 8 heads as ``jnp.repeat`` does, held at 2 heads over one
key/value head, beside the plain causal block of the understanding pathway
at 64 tokens (``cosmos3_und_block``)), and ACE-Step's and Wan-S2V's
(``ACE_KERNEL_CASES``: the cross-attention (1, 24, 253 queries, 385 keys, 64),
query ids 1 and key ids 1 on the speaker, caption and 106 lyric ids, -1 on
the 22 lyric pads; ``S2V_KERNEL_CASES``: the cross-attention (1, 40, 32760
queries, 640 keys, 128) over the 512 umT5 and 128 audio-feature keys,
unmasked), held at 2 heads; at the long shapes the plain version is timed
once, one head at a time, with no warm-up run (the first head warms it);
phases 3 and 7 print the seconds of each of their sections
(``section_s``).  Every phase
line carries ``elapsed_s`` and ``written_gb`` (the card's machine ends a run
that writes more than 45 GiB, deleted files included).  On an H100 80GB HBM3 at
700 W the whole script took 857 s of its 1,200 s limit for phases 1-30 and wrote
45.48 GB (the host's share varies by 10-15% between machines; the fp8 files import
at 3-5 GB/s, their bytes cast on the card): phases 3 and 7 about 115 s, phase 12
about 100 s, phases 17-18 about 180 s, phases 19-24 about 180 s, phases 25-26 about
30 s, phases 27-28 about 75 s, phases 29-30 about 35 s; phases 31-32 add about 60 s
and their kernel cases about 3 s, phases 33-35 about 60 s and theirs about 8 s (phases 1-35:
893 s, 44.79 GB).  To make room for phases 36-38, a run of every
phase checks and times fewer phase-12 steps (``GRAPH_CHECK_STEPS`` and the
timed counts), times the long kernel cases with fewer runs, and cuts SDXL's
level 2 to 2 of its 10 transformer layers (``SDXL_CUT_LAYERS``), Wan and LTX
to 5 blocks, Kandinsky 5.0 to 6 of its 32 visual blocks and Zlab-i1 to 5 of
its 29 blocks in memory; to make room for phases 39-41 it runs phase 18's two
server jobs at once, times fewer phase-8 and phase-12 steps with one profile
of the graphed replay, and cuts AuraFlow to 1 + 2 blocks with Pile-T5 at 2 of
24, SDXL and Kolors to one transformer layer a level and ChatGLM to 1 layer;
PERF.md §7 holds the whole run's seconds and GB.
Then a JSON line with the kernels, each wrapper's head dim 256 instances,
its Chroma row (the Flux shape's times) and its rows at Wan's, LTX's,
Lumina2's, Kandinsky 5.0's, HunyuanVideo's, Qwen-Image's, Z-Image's,
HiDream's, FLUX.2's, Kolors's, LongCat-Image's, Z-Image-Omni's, Zlab-i1's,
Krea-2's, Cosmos's, OmniGen's, ERNIE's, Ideogram's, LongCat-Video's, Sana's,
Sana-Video's, Cosmos3's, LTX-2's, ACE-Step's and Wan-S2V's shapes beside it, and
Anima's rows at Cosmos's shapes
(launches: the profiler's count in phase 12's profiled replay, for the head
dim 256 rows in phase 22's, for the Chroma rows in phase 25's, and for the
other rows the wrappers' count at that shape per step in phase 23's, 24's and
26's-48's runs, per forward for Z-Image-Omni's omni shape),
and last the device line.  Needs one CUDA
device; builds into build/kernels/ inside the checkout.  Phase 2 lists ptxas's
register, spill and warning lines per kernel (a C7514 warning means ptxas
serialized a wgmma pipeline).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib

STEPS = 4
RESOLUTION = 1024
TXT_LEN, TXT_VALID = 512, 77  # T5-XXL max length; a short prompt's real tokens
# kernel vs plain, bf16 (reasons in tests/test_torch_kernels_cuda.py): out
# within two bf16 ulps of the largest reference output and 8e-3 in relative
# L2 (its P-in-bf16 rounding gives about 2.5e-3); lse is f32 on both sides
OUT_REL_MAX, OUT_REL_L2, LSE_ATOL = 2.0 ** -6, 8e-3, 1e-3
# full-width velocity, kernel vs mha_reference path: every attention output
# differs by about one bf16 rounding (P in bf16), and 57 blocks re-round the
# residual stream to bf16 after each op, so the two paths agree to a few
# bf16 ulps in relative L2 (bf16 ulp = 2^-8 = 3.9e-3)
PARITY_REL_L2 = 5e-2
# backward kernels vs mha_backward_reference on the same out/lse/dO (reasons in
# tests/test_torch_kernels_cuda.py): each gradient within two bf16 ulps of its
# largest plain value and 1e-2 in relative L2
GRAD_REL_MAX, GRAD_REL_L2 = 2.0 ** -6, 1e-2
# one train step's LoRA gradients, kernel path vs mha_reference path, 6 blocks
# (phases 9, 11) or the full 57 (phase 13) at full width: each attention
# output and gradient differs by about one bf16 rounding (P and dS in bf16),
# compounded through the blocks' backward
TRAIN_GRAD_REL_L2 = 5e-2
PARITY_DOUBLE, PARITY_SINGLE = 2, 4
# phase 12: steps held bitwise against the eager step, and the eager steps and
# graph replays timed (the replays are the flagship's number: their median;
# 20 replays spread by 0.1% on the card, so 5 give the same median; the eager step
# is a yardstick; 2 checked, 2 eager and 3 replays timed keep the script's time
# in its limit, 3 and 5 before phases 39-41, 5, 6 and 10 before phases 36-38);
# the eager step is profiled in phase 8 and the replay once, by the launch check
GRAPH_CHECK_STEPS, GRAPH_EAGER_TIMED_STEPS, GRAPH_TIMED_STEPS = 2, 2, 3
# H100 SXM: dense bf16 tensor-core peak and device-memory rate (bounds only)
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12
# phase 14: the cut depth of the two-layout Flux checkpoints (full width); the
# depth of phases 17-18 is written and imported once more, as one fp8 BFL file
IMPORT_DOUBLE, IMPORT_SINGLE = 1, 1
# phases 17-18: Flux.1-dev at full width and TRAIN_CUT_BLOCKS (double, single)
# of its 19 + 38 blocks in a run of every phase (the run's time and writes:
# the full depth's fp8 file is 11.9 GB, and its trainer and server jobs took
# 176 s of a run); all 19 + 38 in a run that names phase 17 or 18
TRAIN_CUT_BLOCKS = (2, 4)
# phase 15: bf16 T5-XXL against the f32 module on the same weights and
# tokens: every product and the residual stream round to bf16 (2^-8) in each
# of 24 layers, so the outputs agree to about a percent in relative L2
T5_BF16_REL_L2 = 5e-2
TEXT_PROMPTS = 16
# the T5-XXL file phases 17-19 load: full width, the first 2 of 24 blocks (6
# before phases 31-32 needed the room)
T5_FILE_LAYERS = 2
# phase 16: bf16 VAE encoder against the f32 one: about 20 bf16-rounded
# convolutions deep, the latents agree to about a percent in relative L2
VAE_BF16_REL_L2 = 5e-2
VAE_BATCH, VAE_IMAGES = 8, 24  # one batch of 8 in each of the three Flux buckets
# phase 17: the trainer at full width (``train_blocks``) on 8 of phase 16's JPEGs in two
# buckets (4 square, 4 at 1152x896), checkpoints every 4 of 8 steps, then a
# resumed run from checkpoint-4; the validation prompt renders at 1024 px
TRAIN_STEPS, TRAIN_CHECKPOINT_STEPS, TRAIN_VALIDATION_STEPS = 8, 4, 4
TRAIN_CAPTIONS = [f"a seeded photo number {i}, waves of colour" for i in range(8)]
TRAIN_PROMPT = "a lighthouse on a basalt cliff at dusk"
# the checkpoints refer to the frozen base (checkpoint_frozen_base: reference)
# instead of writing its 12 GB at each of the five saves, which keeps the
# script's writes near 40 GB in all (phases 14-15 write 18 GB, phase 19 18 GB;
# python -m simpletuner_tpu_torch.bench_checkpoint times the full-state save);
# the runs then need a few GB of disk
TRAIN_CHECKPOINT_GB = 4.0
# phase 18: the eval split of the server's training job, phase 16's square
# JPEGs 12 and 15 (phase 17 trains on 0-10)
SERVER_EVAL_IMAGES = (12, 15)
# draws per eval image (eval_timesteps; the registry default is 28, an eager
# full-width forward of about 0.36 s each)
SERVER_EVAL_DRAWS = 4
# phase 19: SD3.5 Large; the render's guidance (true CFG, two forwards per
# Euler step) and the trainer's steps on phase 16's first square JPEGs
SD3_PROMPT = "a lighthouse on a basalt cliff at dusk"
SD3_GUIDANCE = 5.0
SD3_TRAIN_STEPS, SD3_TRAIN_IMAGES = 6, 4
# the CLIP-G (bigG) file phases 19 and 20 load: full width, the first 4 of its
# 32 layers (bf16, 0.29 GB; all 32 would write 1.39 GB), as phase 15's T5-XXL
# and phase 21's OpenCLIP-H are cut, to leave phase 24 room in the write budget
PHASE19_CLIP_G_LAYERS = 4
# phase 20: SDXL (the JAX preset: attention at all three UNet levels, where
# the published SDXL UNet has none at level 0); the render's guidance (true
# CFG, two UNet forwards per step), its schedulers, the trainer's steps and
# min-SNR gamma, and the timestep of the full-depth parity forward
SDXL_GUIDANCE = 7.5
SDXL_TRAIN_STEPS, SDXL_TRAIN_IMAGES = 6, 4
SDXL_SNR_GAMMA = 5.0
SDXL_PARITY_T = 500
SDXL_PROMPT = "a lighthouse on a basalt cliff at dusk"
# phase 21: SD 1.5 (epsilon, 512 px), SD 2.1 (v-prediction, 768 px, the
# published 2.1-v model's size; min-SNR gamma 5) and PixArt-Sigma (epsilon,
# 1024 px, T5-XXL at 300 tokens): (family, resolution, render guidance, the
# trainer's extra keys).  The base files are written as fp8 (e4m3), which the
# importer takes to bf16 exactly, with SD 2.1's OpenCLIP-H at full width and
# PHASE21_CLIP_H_LAYERS of its 23 layers (bf16); what the phase writes in all,
# which phase 20 leaves room for
PHASE21_MODELS = (
    ("sd1x", 512, 7.5, {}),
    ("sd2x", 768, 7.5, {"snr_gamma": 5.0}),
    ("pixart_sigma", 1024, 4.5, {}),
)
PHASE21_CLIP_H_LAYERS = 4
PHASE21_WRITE_GB = 2.82  # 2.81 GB measured
PHASE21_TXT = {"sd1x": 77, "sd2x": 77, "pixart_sigma": 300}
# phases 3 and 7 at SDXL's 1024 px attention: per level, the heads of 64 and
# the H x W image tokens, self-attention and cross-attention against the 77
# CLIP tokens (below one 128-key tile: the kernels' masked mode, no caller mask)
SDXL_TXT = 77
SDXL_LEVELS = ((5, (RESOLUTION // 8) ** 2), (10, (RESOLUTION // 16) ** 2), (20, (RESOLUTION // 32) ** 2))
# phases 3 and 7 at the shapes phase 21 runs first: (name, heads, query
# tokens, key tokens, head dim).  PixArt-Sigma at 1024 px: 16 heads of 72
# (zero-padded to 128 in the wrapper, scaled by 72^-0.5) over 4096 image
# tokens, and against 300 T5 keys with no caller mask (no multiple of the
# 128-key tiles: the last tile runs masked); SD 2.1 at 768 px: level 2's 576
# tokens (4.5 tiles: Sq and Sk ragged) and level 0's 9216; SD 1.5 at 512 px:
# level 2's 256 tokens (its 4096- and 1024-token levels and the 77 keys are
# SDXL's shapes with other head counts)
PHASE21_KERNEL_CASES = (
    ("pixart_self", 16, (RESOLUTION // 16) ** 2, (RESOLUTION // 16) ** 2, 72),
    ("pixart_cross_t5", 16, (RESOLUTION // 16) ** 2, 300, 72),
    ("sd21_l2_self", 20, (768 // 32) ** 2, (768 // 32) ** 2, 64),
    ("sd21_l0_self", 5, (768 // 8) ** 2, (768 // 8) ** 2, 64),
    ("sd15_l2_self", 20, (512 // 32) ** 2, (512 // 32) ** 2, 64),
)
# phase 22: AuraFlow v0.3 at its published size (fal/AuraFlow-v0.3's
# transformer/config.json: 4 joint + 32 single blocks, hidden 3072, 12 heads
# of 256, AuraFlowConfig()) at 1024 px: the render's guidance (true CFG, two
# forwards per Euler step), Pile-T5-XL (the published text_encoder/config.json,
# a umt5 model: d_model 2048, 32 heads of 64, d_ff 5120, gated-silu) at full
# width and the first PHASE22_T5_LAYERS of its 24 blocks, the trainer's steps
# on phase 16's first square JPEGs, and what the phase writes (the e4m3
# transformer, 6.8 GB, and the bf16 Pile-T5, 0.71 GB), which phase 20 leaves
# room for
AURA_GUIDANCE = 3.5
AURA_TRAIN_STEPS, AURA_TRAIN_IMAGES = 6, 4
AURA_PROMPT = "a lighthouse on a basalt cliff at dusk"
AURA_T5_LEN = 256
AURA_TXT = 8 + AURA_T5_LEN  # the register tokens, then the caption
AURA_S = AURA_TXT + (RESOLUTION // 16) ** 2
AURA_SIGMA = 0.7  # the full-depth parity forward's sigma
PHASE22_T5_LAYERS = 2  # 6 before phases 39-41
PHASE22_WRITE_GB = 1.1  # at the cut depths (AURA_CUT_BLOCKS, PHASE22_T5_LAYERS): 1.08 GB measured (2.17 at 2 + 4 and 6)
# phases 3 and 7 at head dim 256, the head dim 256 kernels: (name, (batch,
# heads, seq, head dim), segment ids): AuraFlow's (1, 12, 4360, 256) with no
# caller mask (4360 is no multiple of the 64- and 32-row tiles, so the
# kernels run their masked mode: the ragged tail), 4096 tokens unmasked,
# packed samples with a padded tail, and a head dim of 192, zero-padded to
# 256, with T5 padding; phase 7 adds the cross case at head dim 256
D256_CASES = (
    ("auraflow_s4360_d256", (1, 12, AURA_S, 256), None),
    ("s4096_d256", (1, 12, 4096, 256), None),
    ("segments_s600_d256", (2, 4, 600, 256), {"packed_at": 260, "pad_from": 520}),
    ("t5_padded_s1000_d192", (1, 8, 1000, 192), {"txt_valid": TXT_VALID}),
)
# phase 23: Wan 2.1 T2V-1.3B (Wan-AI/Wan2.1-T2V-1.3B-Diffusers, the JAX preset
# WanConfig.b1_3(): 30 blocks, 1536 wide, 12 heads of 128, FFN 4 x 1536) on its
# published 480p clip, 832 x 480 x 81 frames: 21 x 60 x 104 latents, 21 x 30 x 52
# = 32,760 tokens after the (1, 2, 2) patchify (255 full 128-row tiles and a
# ragged tail of 120), umT5 at 512 tokens (phase 15's T5-XXL file, 2 of 24
# blocks).  Two seeded clips; the render at 480 px square and 81 frames (21 x
# 30 x 30 = 18,900 tokens); the full-depth parity forward on a 17-frame clip
# (5 x 30 x 52 = 7,800 tokens: the plain attention's scores fit); the 14B I2V
# shape (i2v-14b-480p: 5120 wide, 40 heads of 128, 36 channels in) at 4 of its 40
# blocks, built in memory (its 14 GB file has no room in the write budget); what
# the phase writes (the e4m3 transformer, 1.2 GB, two mp4 clips, caches and
# outputs), which phase 20 leaves room for
WAN_FRAMES, WAN_WIDTH, WAN_HEIGHT = 81, 832, 480
WAN_TOKENS = 21 * (WAN_HEIGHT // 16) * (WAN_WIDTH // 16)
WAN_TEXT = 512
WAN_CLIPS, WAN_TRAIN_STEPS = 2, 6
WAN_RENDER_SIZE, WAN_GUIDANCE = 480, 5.0
WAN_PARITY_FRAMES, WAN_SIGMA = 17, 0.7
WAN14B_BLOCKS = 4
WAN_PROMPT = "a lighthouse on a basalt cliff at dusk, waves rolling in"
PHASE23_WRITE_GB = 0.3  # at the cut depth (WAN_CUT_BLOCKS): 0.29 GB measured
# phases 3 and 7 at Wan's attention shapes: (name, heads, query tokens, key
# tokens, head dim): the 1.3B's self-attention (12 heads of 128 over 32,760
# tokens, the ragged tail masked), its cross-attention (the same queries
# against the 512 umT5 keys: 4 key tiles) and the 14B's self-attention (40
# heads).  Held against the plain version at WAN_CHECK_HEADS heads (the heads
# are independent and the plain S x S scores of one head take 4.3 GB in f32);
# timed at the full head count, the plain version head by head
WAN_KERNEL_CASES = (
    ("wan_self", 12, WAN_TOKENS, WAN_TOKENS, 128),
    ("wan_cross", 12, WAN_TOKENS, WAN_TEXT, 128),
    ("wan14b_self", 40, WAN_TOKENS, WAN_TOKENS, 128),
)
WAN_CHECK_HEADS = 2
# phase 24: LTX-Video 0.9.5 2B (Lightricks/LTX-Video-0.9.5, the JAX preset
# LTXConfig(): 28 blocks, 2048 wide, 32 heads of 64, FFN 4 x 2048, T5-XXL
# captions at 128 tokens) on 768 x 512 x 121 clips (sides multiples of 32,
# 8n + 1 frames, as LTX-Video asks): 16 x 16 x 24 latents of 128 channels, and
# with the (1, 1, 1) patch as many tokens, 6,144 (48 full 128-row tiles);
# phase 15's T5-XXL file (2 of 24 blocks).  Two seeded clips; the render at
# 512 px square and 121 frames (16 x 16 x 16 = 4,096 tokens); the full-depth
# parity forward on the training clip's latent grid (the plain attention's
# 6,144^2 scores fit); the 13B width (13b-0.9.7: 4096 wide, 32 heads of 128,
# cross 4096) at 4 of its 48 blocks, built in memory (its 13 GB file has no
# room in the write budget); what the phase writes (the e4m3 transformer, 1.92
# GB, two mp4 clips, caches and outputs), which phase 23 leaves room for
LTX_FRAMES, LTX_WIDTH, LTX_HEIGHT = 121, 768, 512
LTX_LATENT = ((LTX_FRAMES - 1) // 8 + 1, LTX_HEIGHT // 32, LTX_WIDTH // 32)
LTX_TOKENS = LTX_LATENT[0] * LTX_LATENT[1] * LTX_LATENT[2]
LTX_TEXT = 128
LTX_CLIPS, LTX_TRAIN_STEPS = 2, 6
LTX_RENDER_SIZE, LTX_GUIDANCE = 512, 4.0
LTX_SIGMA = 0.7
LTX13B_BLOCKS = 4
LTX_PROMPT = "a lighthouse on a basalt cliff at dusk, waves rolling in"
PHASE24_WRITE_GB = 0.23  # at the cut depth (LTX_CUT_BLOCKS): 0.22 GB measured (0.45 GB at 5 blocks)
# phases 3 and 7 at LTX's attention shapes, as WAN_KERNEL_CASES: the 2B's
# self-attention (32 heads of 64 over 6,144 tokens: full tiles, the unmasked
# fast path), its cross-attention (the same queries against the 128 T5 keys:
# one key tile) and the 13B's self-attention (32 heads of 128); held against
# the plain version at every head (one head at a time), timed at the full
# head count beside the plain version, SDPA's fastest fused backend and the
# bound
LTX_KERNEL_CASES = (
    ("ltx_self", 32, LTX_TOKENS, LTX_TOKENS, 64),
    ("ltx_cross", 32, LTX_TOKENS, LTX_TEXT, 64),
    ("ltx13b_self", 32, LTX_TOKENS, LTX_TOKENS, 128),
)
LTX_CHECK_HEADS = 32
# phase 25: Chroma (lodestones/Chroma's diffusers transformer, ChromaConfig():
# Flux's 19 double + 38 single blocks, 3072 wide, 24 heads of 128, the 5 x 5120
# distilled-guidance approximator; 8.9B parameters) at 1024 px: T5-XXL (phase
# 15's file, 2 of 24 blocks) at 512 tokens, phase 14's Flux VAE; the render's
# true CFG (no guidance embedding: two forwards per Euler step), the trainer's
# steps on phase 16's first square JPEGs, the full-depth parity forward's
# sigma, and what the phase writes (the e4m3 transformer, 8.9 GB, caches and
# outputs)
CHROMA_GUIDANCE = 4.0
CHROMA_TRAIN_STEPS, CHROMA_TRAIN_IMAGES = 6, 4
CHROMA_PROMPT = "a lighthouse on a basalt cliff at dusk"
CHROMA_SIGMA = 0.7
PHASE25_WRITE_GB = 0.71  # at the cut depth (CHROMA_CUT_BLOCKS): 0.69 GB measured (0.81 at 1 + 2)
# phase 26: Lumina-Image 2.0 (Alpha-VLLM/Lumina-Image-2.0's transformer/ as the
# JAX preset Lumina2Config() builds it: 26 joint blocks + 2 context and 2 noise
# refiners, 2304 wide, 24 query / 8 kv heads of 96, SwiGLU 6144; 1.97B
# parameters) at 1024 px, its Gemma-2 2B text encoder (gemma2_2b: 2304 wide, 8
# heads of 256, 4 kv heads, 256,000 tokens) at full width, written at the
# first GEMMA_FILE_LAYERS of its 26 in a run of every phase (as phase 15 cuts
# T5) and at full depth in a run that names phase 26 where the run's writes
# leave room, captions at 256 tokens;
# phase 14's Flux VAE.  The render's true CFG, the trainer's steps, the parity
# sigma, bf16 Gemma-2 against the f32 module (as T5_BF16_REL_L2), and what the
# phase writes with the cut Gemma-2 (the e4m3 transformer 1.97 GB, Gemma-2
# 1.06 GB, caches and outputs)
LUMINA_CAP, LUMINA_VALID = 256, 180  # caption tokens; a prompt's valid ones in the kernel cases
LUMINA_IMG = (RESOLUTION // 16) ** 2
LUMINA_S = LUMINA_CAP + LUMINA_IMG
LUMINA_GUIDANCE = 4.0
LUMINA_TRAIN_STEPS, LUMINA_TRAIN_IMAGES = 6, 4
LUMINA_PROMPT = "a lighthouse on a basalt cliff at dusk"
LUMINA_SIGMA = 0.7
GEMMA_FILE_LAYERS = 2
# a decoder LLM's bf16 states against the f32 module on the same weights and
# tokens (phases 26-28): every product and the residual stream round to bf16
# in each layer, so they agree to about a percent in relative L2
LLM_BF16_REL_L2 = 5e-2
PHASE26_WRITE_GB = 1.26  # at the cut depths (LUMINA_CUT_BLOCKS, GEMMA_FILE_LAYERS): 1.24 GB measured (1.45 at 6 blocks)
# phases 3 and 7 at Lumina2's attention shapes (D = 96, zero-padded to 128 by
# the wrappers, scaled by 96^-0.5): (name, heads, query tokens, key tokens,
# head dim, valid caption tokens or None): the joint layers over [256 caption,
# 4096 image] tokens with a caption-mask segment plane (180 valid caption
# tokens and the image at 1, the 76 pads at 0, not -1: the JAX module's
# ids), the noise refiners' 4096 image tokens unmasked and the context
# refiners' 256 caption tokens masked the same way; held against the plain
# version at every head (one head at a time)
LUMINA_KERNEL_CASES = (
    ("lumina_joint", 24, LUMINA_S, LUMINA_S, 96, LUMINA_VALID),
    ("lumina_noise_refiner", 24, LUMINA_IMG, LUMINA_IMG, 96, None),
    ("lumina_context_refiner", 24, LUMINA_CAP, LUMINA_CAP, 96, LUMINA_VALID),
)
LUMINA_CHECK_HEADS = 24
# phase 27: Kandinsky 5.0 Lite (ai-forever/Kandinsky-5.0-T2V-Lite-sft-5s and
# Kandinsky-5.0-T2I-Lite's transformer/, as the JAX preset Kandinsky5Config()
# builds it: 32 visual and 2 text blocks, 2048 wide, 32 heads of 64, FFN 5120,
# 4 latent channels; 2.15B parameters; one e4m3 file for both flavours) with
# Qwen2.5-VL-7B's text trunk (qwen25_7b: 3584 wide, 28 query / 4 kv heads of
# 128, FFN 18,944, 152,064 tokens, qkv biases) at full width and the first
# QWEN_FILE_LAYERS of its 28 layers in a run of every phase (as phase 15 cuts
# T5), captions at 512 tokens, and phase 14's CLIP-L pooled.  The image
# flavour at 1024 px (the 4-channel SD VAE: 128 x 128 latents, 4,096 tokens);
# the video flavour on two seeded 768 x 512 x 61 clips (the published 5 s clip
# is 121 frames, 47,616 tokens: cut to 61 for the time limit; the Wan-config
# video VAE at 4 latents: 16 x 64 x 96 latents, 16 x 32 x 48 = 24,576
# tokens), its render at 512 px square and 61 frames (16,384 tokens), its
# parity forward on a 17-frame clip (5 x 32 x 48 = 7,680 tokens)
K5_PROMPT = "a lighthouse on a basalt cliff at dusk, waves rolling in"
K5_TEXT = 512
K5_GUIDANCE = 5.0
K5_TRAIN_STEPS, K5_TRAIN_IMAGES = 6, 4
K5_IMAGE_TOKENS = (RESOLUTION // 16) ** 2
K5_FRAMES, K5_WIDTH, K5_HEIGHT = 61, 768, 512
K5_LATENT = ((K5_FRAMES - 1) // 4 + 1, K5_HEIGHT // 8, K5_WIDTH // 8)
K5_TOKENS = K5_LATENT[0] * (K5_LATENT[1] // 2) * (K5_LATENT[2] // 2)
K5_CLIPS, K5_RENDER_SIZE, K5_PARITY_FRAMES, K5_SIGMA = 2, 512, 17, 0.7
QWEN_FILE_LAYERS = 2
PHASE27_WRITE_GB = 1.53  # at the cut depths (K5_CUT_BLOCKS, QWEN_FILE_LAYERS): 1.52 GB measured (1.60 at 3 blocks, 1.84 at 6)
# phases 3 and 7 at Kandinsky 5.0's attention shapes (D = 64, unmasked: the
# JAX family drops the Qwen mask): the video flavour's self-attention over
# 24,576 tokens (192 full tiles) and its cross-attention against the 512 Qwen
# keys; held against the plain version at K5_CHECK_HEADS heads, one at a time
K5_KERNEL_CASES = (
    ("k5_self", 32, K5_TOKENS, K5_TOKENS, 64),
    ("k5_cross", 32, K5_TOKENS, K5_TEXT, 64),
)
K5_CHECK_HEADS = 2
# phase 28: HunyuanVideo 1.5 t2v-480p (tencent/HunyuanVideo-1.5's
# transformer/ as the JAX preset HunyuanVideo15Config() builds it: 54
# dual-stream and 2 refiner blocks, 2048 wide, 16 heads of 128, 65 channels
# in, 32 out; 8.33B parameters) at HY_CUT_BLOCKS of its 54 blocks in a run of
# every phase, phase 27's Qwen2.5-VL trunk at 256 tokens (linked) and a
# seeded ByT5-small (google/byt5-small's config.json: d_model 1472, 6 heads
# of 64, d_ff 3584, 12 layers, gated-gelu, 384 tokens; bf16) at 77 tokens,
# on two seeded 848 x 480 x 17 clips (the JAX preset's 8x video VAE at 32
# latents: 5 x 60 x 106 latents, 31,800 video tokens with the (1, 1, 1)
# patch; the published 121 frames would give 197,160: cut for the time
# limit), the render at 480 px square and 17 frames, the parity forward on a
# 5-frame clip with padded captions
HY_PROMPT = "a lighthouse on a basalt cliff at dusk, waves rolling in"
HY_TEXT, HY_TEXT2 = 256, 77
HY_GUIDANCE = 6.0
HY_TRAIN_STEPS = 6
HY_FRAMES, HY_WIDTH, HY_HEIGHT = 17, 848, 480
HY_LATENT = ((HY_FRAMES - 1) // 4 + 1, HY_HEIGHT // 8, HY_WIDTH // 8)
HY_VIDEO = HY_LATENT[0] * HY_LATENT[1] * HY_LATENT[2]
HY_JOINT = HY_VIDEO + HY_TEXT + HY_TEXT2
HY_CLIPS, HY_RENDER_SIZE, HY_PARITY_FRAMES, HY_SIGMA = 2, 480, 5, 0.7
HY_QWEN_VALID, HY_BYT5_VALID = 180, 40  # a caption's valid tokens in the kernel cases
PHASE28_WRITE_GB = 1.1  # at the cut depth (HY_CUT_BLOCKS): 1.09 GB measured (1.56 at 6 blocks)
# phases 3 and 7 at HunyuanVideo's attention shapes (D = 128): the joint
# attention over 31,800 video tokens then 256 Qwen and 77 ByT5 tokens with
# the segment plane the DiT makes (video and valid tokens at 0, pads at -1:
# 180 and 40 valid), and the token refiner's 256 Qwen tokens (180 valid);
# held against the plain version at HY_CHECK_HEADS heads, one at a time
HY_KERNEL_CASES = (
    ("hy_joint", 16, HY_JOINT, HY_JOINT, 128, "hy_joint"),
    ("hy_refiner", 16, HY_TEXT, HY_TEXT, 128, "hy_refiner"),
)
HY_CHECK_HEADS = 2
# phase 29: Qwen-Image (Qwen/Qwen-Image's transformer/ as the JAX preset
# QwenImageConfig() builds it: 60 double-stream blocks, 3072 wide, 24 heads of
# 128, 64 packed channels in; 20.4B parameters) at QI_CUT_BLOCKS of its 60
# blocks in a run of every phase, phase 27's Qwen2.5-VL trunk at 1024 tokens
# (linked), at 1024 px (64 x 64 = 4,096 packed tokens after 1,024 unmasked
# text tokens: 5,120 joint); Z-Image (Tongyi-MAI/Z-Image-Turbo as the JAX
# family builds it: the same block layout without text rope, 19 blocks, 2560-
# wide Qwen features, 4,096 text tokens: 8,192 joint) at ZI_CUT_BLOCKS of its
# 19 blocks built in memory, with a seeded 2560-wide qwen2-layout trunk (the
# JAX family's qwen2.5 spec at Qwen3-4B's sizes from its config.json: 32 heads
# of 128, 8 kv heads, FFN 9728, 151,936 tokens) at ZI_TRUNK_LAYERS of its 36
QI_PROMPT = "a lighthouse on a basalt cliff at dusk"
QI_TEXT, ZI_TEXT = 1024, 4096
QI_IMG = (RESOLUTION // 16) ** 2
QI_GUIDANCE, QI_SIGMA = 4.0, 0.7
QI_TRAIN_STEPS, QI_TRAIN_IMAGES = 6, 4
ZI_CUT_BLOCKS, ZI_TRUNK_LAYERS = 2, 2
PHASE29_WRITE_GB = 1.31  # at the cut depths (QI_CUT_BLOCKS, ZI_TRUNK_LAYERS): 1.30 GB measured (1.67 at 2 blocks)
# phases 3 and 7 at Qwen-Image's and Z-Image's joint attention (D = 128,
# unmasked: the JAX families drop the mask); held at QI_CHECK_HEADS heads
QI_KERNEL_CASES = (
    ("qi_joint", 24, QI_IMG + QI_TEXT, QI_IMG + QI_TEXT, 128),
    ("zi_joint", 24, QI_IMG + ZI_TEXT, QI_IMG + ZI_TEXT, 128),
)
QI_CHECK_HEADS = 2
# phase 30: HiDream-I1 (HiDream-ai/HiDream-I1-Full's transformer/ as the JAX
# preset HiDreamConfig() builds it: 16 double and 32 single blocks, 20 heads of
# 128, 4 experts top-2 with a shared expert; 17.1B parameters) at
# HD_CUT_BLOCKS of its 16 + 32 blocks in a run of every phase, with phase 14's
# CLIP-L, phase 19's CLIP-G (4 of its 32 layers), phase 15's T5-XXL (2 of 24)
# and a seeded Llama-3.1-8B trunk (``llama3_8b``: 4096 wide, 32 heads, 8 kv
# heads, FFN 14,336, 128,256 tokens) at LLAMA_FILE_LAYERS of its 32 layers, at
# 1024 px: 4,096 image tokens, 128 T5, 128 Llama[last] and the block's 128
# Llama tokens (4,480 joint, unmasked)
HD_PROMPT = "a lighthouse on a basalt cliff at dusk"
HD_TEXT = 128
HD_JOINT = QI_IMG + 3 * HD_TEXT
HD_GUIDANCE, HD_SIGMA = 5.0, 0.7
HD_TRAIN_STEPS, HD_TRAIN_IMAGES = 6, 4
LLAMA_FILE_LAYERS = 2
PHASE30_WRITE_GB = 1.83  # at the cut depths (HD_CUT_BLOCKS, LLAMA_FILE_LAYERS): 1.82 GB measured
HD_KERNEL_CASES = (
    ("hd_joint", 20, HD_JOINT, HD_JOINT, 128),
)
HD_CHECK_HEADS = 2
# phase 31: FLUX.2-dev (black-forest-labs/FLUX.2-dev's transformer/ as the JAX
# preset Flux2Config() builds it: 8 double and 48 single blocks, 6144 wide, 48
# heads of 128, 32 latent channels, guidance embedding; 32.2B parameters) at
# F2_CUT_BLOCKS of its 8 + 48 blocks in a run of every phase, with a seeded
# Mistral-3 24B trunk at MISTRAL_LAYERS of its 40 layers built in memory whose
# three taps (the embeddings and both layers' outputs) make the 15,360
# features, at 1024 px: 128 x 128 x 32 latents, 4,096 image tokens after 512
# text tokens (4,608 joint, unmasked); the klein width at 1 + 1 blocks
F2_PROMPT = "a lighthouse on a basalt cliff at dusk"
F2_TEXT = 512
F2_IMG = (RESOLUTION // 16) ** 2
F2_JOINT = F2_IMG + F2_TEXT
F2_GUIDANCE, F2_SIGMA = 4.0, 0.7
F2_TRAIN_STEPS = 6
F2_TAPS = "[-3, -2, -1]"
MISTRAL_LAYERS = 2
PHASE31_WRITE_GB = 2.3  # at the cut depth (F2_CUT_BLOCKS): 2.29 GB measured, the file
F2_KERNEL_CASES = (
    ("f2_joint", 48, F2_JOINT, F2_JOINT, 128),
)
F2_CHECK_HEADS = 2
# phase 32: Kolors (Kwai-Kolors/Kolors-diffusers' unet/ as the JAX family
# builds it: SDXL's UNet with the cross-attention 4,096 wide and a 4,096-wide
# pooled vector in addition_embed_dim 5,632; 2.94B parameters) with the
# level-2 transformer depth cut to KOLORS_CUT_LAYERS in a run of every phase,
# a seeded ChatGLM3-6B trunk at GLM_FILE_LAYERS of its 28 layers, at 1024 px:
# SDXL's three attention levels over 16,384, 4,096 and 1,024 tokens, the
# cross-attention against 256 unmasked ChatGLM keys
KOLORS_PROMPT = "a lighthouse on a basalt cliff at dusk"
KOLORS_TEXT = 256
KOLORS_GUIDANCE, KOLORS_PARITY_T = 5.0, 500
KOLORS_TRAIN_STEPS, KOLORS_TRAIN_IMAGES = 6, 4
KOLORS_CUT_LAYERS = (1, 1, 1)  # (1, 2, 2) before phases 39-41
GLM_FILE_LAYERS = 1  # 2 before phases 39-41
PHASE32_WRITE_GB = 1.3  # at the cut depths (KOLORS_CUT_LAYERS, GLM_FILE_LAYERS): 1.28 GB measured (1.85 at (1, 2, 2) and 2)
KOLORS_KERNEL_CASES = tuple(case for level, (heads, seq) in enumerate(SDXL_LEVELS) for case in (
    (f"kolors_l{level}_self", heads, seq, seq, 64), (f"kolors_l{level}_cross", heads, seq, KOLORS_TEXT, 64)))
KOLORS_CHECK_HEADS = 2
# phase 33: LongCat-Image (meituan-longcat/LongCat-Image's transformer/ as the
# JAX family builds it: Flux's 19 double and 38 single blocks at 3072 wide, 24
# heads of 128, 3584-wide Qwen2.5-VL text, no pooled or guidance embedder;
# 11.9B parameters) at LC_CUT_BLOCKS of its 19 + 38 blocks in a run of every
# phase, with the Qwen2.5-VL-7B trunk of phases 27-29 (2 of 28 layers,
# linked), at 1024 px.  The captioning template's spans under the word-level
# tokenizer (40 + 8 tokens with its <bos>; the published tokenizer's are 36 +
# 5) leave 464 of the 512 Qwen tokens: 4,096 image tokens after 464 text
# tokens (4,560 joint, unmasked); the edit flavour adds 4,096 reference tokens
LC_PROMPT = "a lighthouse on a basalt cliff at dusk"
LC_TEXT = 512 - 40 - 8
LC_IMG = (RESOLUTION // 16) ** 2
LC_JOINT, LC_EDIT_JOINT = LC_TEXT + LC_IMG, LC_TEXT + 2 * LC_IMG
LC_GUIDANCE, LC_SIGMA = 4.0, 0.7
LC_TRAIN_STEPS, LC_TRAIN_IMAGES = 6, 4
LC_CUT_BLOCKS = (1, 1)
PHASE33_WRITE_GB = 0.59  # at the cut depth: 0.58 GB measured, 0.52 GB the file
LC_KERNEL_CASES = (
    ("lc_joint", 24, LC_JOINT, LC_JOINT, 128),
    ("lc_edit_joint", 24, LC_EDIT_JOINT, LC_EDIT_JOINT, 128),
)
LC_CHECK_HEADS = 2
# phase 34: Z-Image-Omni (Tongyi-MAI/Z-Image-Omni's transformer/ as the JAX
# preset ZImageOmniConfig() builds it: 30 layers and 2 + 2 + 2 refiners, 3840
# wide, 30 heads of 128; 6.51B parameters) at ZO_CUT_BLOCKS (layers, refiner
# depth) in a run of every phase, phase 29's 2560-wide qwen2 trunk (2 layers,
# linked), at 1024 px: 512 caption tokens (the qwen2.5 spec's length) and
# 4,096 image tokens, 4,608 joint with segment ids all 1 (the JAX module
# passes them); the omni forward adds 4,096 reference tokens and a 32 x 32
# SigLIP grid (a SigLIP2 at 512 px in patches of 16); Boogu-Image (Lumina2's
# layout) at BOOGU_BLOCKS of its 26 blocks in memory
ZO_PROMPT = "a lighthouse on a basalt cliff at dusk"
ZO_TEXT = 512
ZO_SIGLIP = (32, 32)
ZO_JOINT = ZO_TEXT + LC_IMG
ZO_OMNI_JOINT = ZO_TEXT + 2 * LC_IMG + ZO_SIGLIP[0] * ZO_SIGLIP[1]
ZO_GUIDANCE, ZO_SIGMA = 4.0, 0.7
ZO_TRAIN_STEPS, ZO_TRAIN_IMAGES = 6, 4
ZO_CUT_BLOCKS = (1, 1)
BOOGU_BLOCKS = 2
PHASE34_WRITE_GB = 0.85  # at the cut depth: 0.84 GB measured, 0.73 GB the file
ZO_KERNEL_CASES = (
    ("zo_joint", 30, ZO_JOINT, ZO_JOINT, 128, "ones"),
    ("zo_omni_joint", 30, ZO_OMNI_JOINT, ZO_OMNI_JOINT, 128, "ones"),
    ("zo_noise_refiner", 30, LC_IMG, LC_IMG, 128),
    ("zo_context_refiner", 30, ZO_TEXT, ZO_TEXT, 128),
)
ZO_CHECK_HEADS = 2
# phase 35: Zlab-i1 (zlab-princeton/i1-3B's transformer/ as the JAX preset
# ZlabI1Config() builds it: 2016 wide, 28 heads of 72, 29 U-ViT blocks, 32
# latent channels; 3.17B parameters), its checkpoint written at
# ZL_FILE_BLOCKS of 29 and all 29 built in memory, with a Gemma-2 2B at
# GEMMA_ZL_LAYERS of its 26 layers in memory, at 1024 px: 4,096 image tokens
# and 256 text tokens (180 valid in the kernel cases) in the masked joint
# attention (query ids 1, key ids the text mask), the connector's 256 unmasked
ZL_PROMPT = "a lighthouse on a basalt cliff at dusk"
ZL_TEXT, ZL_VALID = 256, 180
ZL_JOINT = LC_IMG + ZL_TEXT
ZL_SIGMA = 0.7
ZL_TRAIN_STEPS = 6
ZL_FILE_BLOCKS = 3
GEMMA_ZL_LAYERS = 2
PHASE35_WRITE_GB = 0.44  # 0.42 GB measured, the file
ZL_KERNEL_CASES = (
    ("zl_joint", 28, ZL_JOINT, ZL_JOINT, 72, "zl_joint"),
    ("zl_connector", 28, ZL_TEXT, ZL_TEXT, 72),
)
ZL_CHECK_HEADS = 2
# phase 36: Krea-2 (krea/krea-2's transformer/ as the JAX preset Krea2Config()
# builds it: 6144 wide, 48 query and 12 key/value heads of 128, 28 blocks, a
# 2560-wide text fusion of 2 layerwise and 2 refiner blocks over 12 taps;
# 12.82B parameters), its checkpoint written at K2_FILE_BLOCKS of 28 with the
# four fusion blocks, phase 29's 2560-wide qwen2 trunk linked, at 1024 px:
# 4,096 image tokens after 512 text tokens (K2_VALID valid in the kernel
# cases) in the joint attention (K/V repeated from 12 to 48 heads, query ids
# 1, key ids the text mask), the edit's 4,096 reference tokens more, and the
# refiners' 512 masked text tokens; all 28 blocks in memory in a named run
K2_PROMPT = "a lighthouse on a basalt cliff at dusk"
K2_TEXT, K2_VALID = 512, 300
K2_JOINT = K2_TEXT + LC_IMG
K2_EDIT_JOINT = K2_TEXT + 2 * LC_IMG
K2_GUIDANCE = 4.5
K2_SIGMA = 0.7
K2_TRAIN_STEPS, K2_TRAIN_IMAGES = 6, 4
K2_FILE_BLOCKS = 1
PHASE36_WRITE_GB = 1.41  # 1.39 GB measured: the 1.10 GB file and the 12-tap text cache
K2_KERNEL_CASES = (
    ("k2_joint", 48, K2_JOINT, K2_JOINT, 128, "k2_joint"),
    ("k2_edit_joint", 48, K2_EDIT_JOINT, K2_EDIT_JOINT, 128, "k2_joint"),
    ("k2_refiner", 20, K2_TEXT, K2_TEXT, 128, "k2_refiner"),
)
K2_CHECK_HEADS = 4  # one key/value head repeated to four query heads
# the layerwise fusion attention: each of the 512 text tokens a sequence of its
# 12 taps (20 heads of 128, unmasked); forward only on the path (the text stage
# has no adapter and takes no gradient), so phase 3 alone holds it
K2_FUSION_CASES = (("k2_layerwise", 20, 12, 12, 128, None, K2_TEXT),)
# phase 37: Cosmos-Predict2 2B (nvidia/Cosmos-Predict2-2B-Text2Image's
# transformer/ as the JAX preset Cosmos1Config.predict2_2b() builds it: 2048
# wide, 16 heads of 128, 28 blocks; 1.96B parameters), its checkpoint at
# CO_FILE_BLOCKS of 28, a T5-11B encoder (1024 wide, 128 heads of 128, relu
# FFN 65,536) at T5_11B_LAYERS of its 24 blocks, at 1024 px: 4,096 image
# tokens in the self-attention and against 512 T5 keys (unmasked), and the
# 14B width (40 heads of 128) at CO14B_BLOCKS of 36 in memory
CO_PROMPT = "a lighthouse on a basalt cliff at dusk"
CO_TEXT = 512
CO_GUIDANCE = 7.0
CO_SIGMA = 1.5  # an EDM sigma
CO_TRAIN_STEPS, CO_TRAIN_IMAGES = 6, 4
CO_FILE_BLOCKS, T5_11B_LAYERS, CO14B_BLOCKS = 4, 1, 2
PHASE37_WRITE_GB = 0.61  # 0.60 GB measured: 0.30 GB the transformer, 0.23 GB T5
CO_KERNEL_CASES = (
    ("co_self", 16, LC_IMG, LC_IMG, 128),
    ("co_cross", 16, LC_IMG, CO_TEXT, 128),
    ("co14b_self", 40, LC_IMG, LC_IMG, 128),
    ("co14b_cross", 40, LC_IMG, CO_TEXT, 128),
)
CO_CHECK_HEADS = 2
# phase 38: Anima (circulus/anima's transformer/ as the JAX preset
# AnimaConfig() builds it: the 6-layer, 1024-wide LLM adapter over 32,128 T5
# ids on the 2B Cosmos core; 2.09B parameters), its checkpoint at the full
# adapter and AN_FILE_BLOCKS of the core's 28, a Qwen3-0.6B trunk (1024
# wide, in the qwen2 layout) at QWEN3_06B_LAYERS of its 28 layers: the core's
# shapes are Cosmos's (its context the adapter's 64 tokens padded to 512);
# the adapter's attentions run the plain version
AN_PROMPT = "a lighthouse on a basalt cliff at dusk"
AN_TEXT, AN_T5 = 256, 64
AN_GUIDANCE = 4.0
AN_SIGMA = 0.7
AN_TRAIN_STEPS, AN_TRAIN_IMAGES = 6, 4
AN_FILE_BLOCKS, QWEN3_06B_LAYERS = 4, 2
PHASE38_WRITE_GB = 0.7  # 0.68 GB measured: 0.43 GB the transformer, 0.19 GB the trunk
# the LLM adapter's attentions (16 heads of 64): self over the 64 T5 ids and
# cross into the 256 Qwen states, unmasked; forward only on the path (the
# adapter has no LoRA and its inputs take no gradient), so phase 3 alone holds them
AN_ADAPTER_CASES = (("an_self", 16, AN_T5, AN_T5, 64), ("an_cross", 16, AN_T5, AN_TEXT, 64))
# phase 39: OmniGen (Shitao/OmniGen-v1-diffusers' transformer/ as the JAX
# preset OmniGenConfig() builds it: a 3072-wide Phi-3 decoder, 32 query and 32
# key/value heads of 96, 32 layers, the fused gate_up SwiGLU 16,384 wide, a
# 32,064-row token table; 3.76B parameters), its checkpoint at OG_FILE_BLOCKS
# of 32 with a seeded word-level tokenizer at Phi-3's 32,064 ids: 120 prompt
# tokens (OG_VALID valid in the kernel cases), the time token and 4,096 image
# tokens, 4,217 in the joint sequence; the image rows (4,096 queries against
# every key, the text pads masked as keys) through the flash kernels at head
# dim 96 zero-padded to 128, the 121 prefix rows a plain causal block; all 32
# layers in memory in a named run
OG_PROMPT = "a lighthouse on a basalt cliff at dusk"
OG_TEXT, OG_VALID = 120, 77
OG_PREFIX = OG_TEXT + 1
OG_JOINT = OG_PREFIX + LC_IMG
OG_GUIDANCE = 3.0
OG_SIGMA = 0.7
OG_TRAIN_STEPS, OG_TRAIN_IMAGES = 6, 4
OG_FILE_BLOCKS = 2
OG_VOCAB = 32064
PHASE39_WRITE_GB = 0.41  # 0.40 GB measured: the 0.36 GB file and the caches (0.17 GB more where phase 20's VAE is gone)
OG_KERNEL_CASES = (("og_image_rows", 32, LC_IMG, OG_JOINT, 96, "og_keys"),)
OG_CHECK_HEADS = 2
# phase 40: ERNIE-Image (baidu/ERNIE-4.5-VL-image's transformer/ as the JAX
# preset ErnieConfig() builds it: 3072 wide, 24 heads of 128, 24 layers, FFN
# 8192, 128 packed input channels, a 2560 -> 3072 text_proj; 2.82B
# parameters), its checkpoint at ER_FILE_BLOCKS of 24, phase 29's 2560-wide
# qwen2-layout trunk linked (the qwen2.5 spec's final-norm states at 512
# tokens): the joint [4,096 image | 512 text] with query ids 1 and key ids 1
# for the image and the first ER_VALID text tokens (the pads at -1); its
# 32-channel latents meet the 16-channel Flux VAE the trainer builds, so the
# step goes through build_train_step and the sampler loop stops before a
# decode; all 24 layers in memory in a named run
ER_PROMPT = "a lighthouse on a basalt cliff at dusk"
ER_TEXT, ER_VALID = 512, 300
ER_JOINT = LC_IMG + ER_TEXT
ER_GUIDANCE = 4.0
ER_SIGMA = 0.7
ER_TRAIN_STEPS = 6
ER_FILE_BLOCKS = 2
PHASE40_WRITE_GB = 0.34  # 0.33 GB measured, the file
ER_KERNEL_CASES = (("er_joint", 24, ER_JOINT, ER_JOINT, 128, "er_joint"),)
ER_CHECK_HEADS = 2
# phase 41: Ideogram (ideogram-ai/ideogram-v3-fp8's transformer/ as the JAX
# preset IdeogramConfig() builds it: 4608 wide, 18 heads of 256, 34 layers, FFN
# 12,288, 13 taps of a 4096-wide Qwen3-VL trunk concatenated to 53,248
# features; 9.28B parameters), its checkpoint at ID_FILE_BLOCKS of 34 with the
# whole llm_cond_proj, a seeded 4096-wide qwen2-layout trunk (Qwen3-VL-8B's
# text sizes) at ID_TRUNK_LAYERS of 36 built in memory (its loader held on the
# CPU; 13 taps spread over its 3 states): the joint [512 text | 4,096 image]
# at head dim 256 with the text mask as segment ids (ID_VALID valid, the pads
# at 0 attending to each other); build_train_step and the sampler loop without
# a decode, as ERNIE's; the enhancer's greedy loop for ID_UPSAMPLE_TOKENS on a
# seeded LM head held on the card (151,936 x 4096 f32: not written); all 34
# layers in memory in a named run
ID_PROMPT = "a lighthouse on a basalt cliff at dusk"
ID_TEXT, ID_VALID = 512, 300
ID_JOINT = ID_TEXT + LC_IMG
ID_GUIDANCE = 4.0
ID_SIGMA = 0.7
ID_TRAIN_STEPS = 6
ID_FILE_BLOCKS, ID_TRUNK_LAYERS = 1, 2
ID_UPSAMPLE_TOKENS = 8
PHASE41_WRITE_GB = 0.57  # 0.56 GB measured, the file
ID_KERNEL_CASES = (("id_joint", 18, ID_JOINT, ID_JOINT, 256, "id_joint"),)
ID_CHECK_HEADS = 2
# phase 42: LongCat-Video (meituan-longcat/LongCat-Video's dit/ as the JAX
# preset LongCatVideoConfig() builds it: 4096 wide, 32 heads of 128, 48
# blocks, SwiGLU 11,008, T5-XXL captions at 512 tokens; 13.58B parameters) on
# phase 23's clip, 832 x 480 x 81 frames: 21 x 30 x 52 = 32,760 tokens, its
# checkpoint at LV_FILE_BLOCKS of 48 beside phase 15's T5-XXL (linked); the
# render at 480 px square and LV_RENDER_FRAMES frames, the parity forward on
# a 17-frame clip; all 48 blocks in memory in a named run
LV_PROMPT = "a lighthouse on a basalt cliff at dusk, waves rolling in"
LV_TEXT = 512
LV_CLIPS, LV_TRAIN_STEPS = 2, 6
LV_GUIDANCE, LV_SIGMA = 4.0, 0.7
LV_RENDER_FRAMES, LV_PARITY_FRAMES = 17, 17
LV_FILE_BLOCKS = 2
LV_FULL_STEPS = 3  # timed replays of the named run's 48-block step
PHASE42_WRITE_GB = 0.71  # 0.70 GB measured: the 0.60 GB file, two clips and their caches
# phases 3 and 7 at LongCat-Video's shapes: the self-attention over the clip
# (32 heads of 128, the ragged tail masked by the kernels) and the
# cross-attention against the 512 T5 keys with query ids 1 and the first
# LV_VALID keys at 1, the pads at -1 (a seeded caption's mask)
LV_VALID = 300
LV_KERNEL_CASES = (("lv_self", 32, WAN_TOKENS, WAN_TOKENS, 128),
                   ("lv_cross", 32, WAN_TOKENS, LV_TEXT, 128, "lv_keys"))
LV_CHECK_HEADS = 2
# phase 43: Sana 1600M (Efficient-Large-Model/Sana_1600M_1024px_diffusers'
# transformer/ as the JAX preset SanaConfig() builds it: 2240 wide, 20
# blocks, 70 linear heads of 32, 20 cross heads of 112, Mix-FFN 5600, 32
# latent channels; 1.60B parameters) at 1024 px (32 x 32 = 1,024 tokens of
# DC-AE latents), its checkpoint at SA_FILE_BLOCKS of 20, a seeded Gemma-2 2B
# (gemma2_2b at GEMMA_FILE_LAYERS of 26, e4m3) that phase 44 links; the
# 32-channel latents meet the 16-channel Flux VAE the trainer builds, so the
# step goes through build_train_step and the sampler loop stops before a
# decode; all 20 blocks in memory in a named run
SA_PROMPT = "a lighthouse on a basalt cliff at dusk"
SA_TEXT = 300
SA_IMG = (RESOLUTION // 32) ** 2
SA_GUIDANCE, SA_SIGMA = 4.5, 0.7
SA_TRAIN_STEPS = 6
SA_FILE_BLOCKS = 4
PHASE43_WRITE_GB = 1.12  # 1.10 GB measured: the 0.36 GB file and the 0.75 GB Gemma-2
SA_KERNEL_CASES = (("sa_cross", 20, SA_IMG, SA_TEXT, 112),)
SA_CHECK_HEADS = 2
# phase 44: Sana-Video 2B (Efficient-Large-Model/SANA-Video_2B_480p's
# transformer/ as the JAX preset SanaVideoConfig() builds it: 20 heads of
# 112, 2240 wide, 20 blocks, GLUMBTempConv 5600; 1.91B parameters) on phase
# 42's clips (linked, with their VAE latents), its checkpoint at
# SV_FILE_BLOCKS of 20, phase 43's Gemma-2 linked; all 20 blocks in memory
# in a named run
SV_PROMPT = LV_PROMPT
SV_TEXT = 300
SV_TRAIN_STEPS = 6
SV_GUIDANCE, SV_SIGMA = 6.0, 0.7
SV_FILE_BLOCKS = 4
PHASE44_WRITE_GB = 0.49  # 0.48 GB measured: the 0.42 GB file and the caches
# the cross-attention over the clip against 300 Gemma keys, query ids 1 and
# the first SV_VALID keys at 1 (the -10000 key bias as key ids)
SV_VALID = 120
SV_KERNEL_CASES = (("sv_cross", 20, WAN_TOKENS, SV_TEXT, 112, "sv_keys"),)
SV_CHECK_HEADS = 2
# phase 45: Cosmos3 (the omni MoT as the JAX preset Cosmos3Config() builds
# it: a Qwen3-VL backbone, 4096 wide, 36 layers of two pathways, 32 query and
# 8 kv heads of 128, SwiGLU 12,288, a 151,936-row token table and lm_head, 48
# latent channels in 2 x 2 patches; 15.16B parameters) on a 1280 x 704 x 93
# clip in the Wan-2.2-style 48-channel latent (24 x 44 x 80: 21,120 generation
# tokens behind the 64 text ids), its seeded file at C3_FILE_LAYERS of 36 with
# the whole table and head (all 36 layers in memory in a named run); the
# parity forward and the replay identity on a 17-frame clip (5 latent
# frames: 4,400 generation tokens); the AVAE audio tokenizer at its shipped
# config on 10 s of 48 kHz stereo, held against float64 on a 1 s excerpt
C3_PROMPT = "a lighthouse on a basalt cliff at dusk, waves rolling in"
C3_TEXT = 64
C3_LATENT = (24, 44, 80)  # (93 - 1) // 4 + 1 frames, 704 / 16, 1280 / 16
C3_PARITY_LATENT = (5, 44, 80)  # 17 frames
C3_GEN = C3_LATENT[0] * (C3_LATENT[1] // 2) * (C3_LATENT[2] // 2)
C3_KEYS = C3_TEXT + C3_GEN
C3_GUIDANCE, C3_SIGMA = 4.0, 0.7
C3_TRAIN_STEPS, C3_FULL_STEPS = 6, 3
C3_FILE_LAYERS = 1  # 2 before phase 46 needed the room
C3_AUDIO_RATE, C3_AUDIO_SECONDS, C3_AUDIO_EXCERPT = 48000, 10, 48000
# the AVAE's f32 encode / decode on the card against float64 on the CPU
# (TF32 off): f32 rounding through 5 up-sampling blocks of 3 residual units
C3_AVAE_REL_L2 = 1e-4
PHASE45_WRITE_GB = 1.66  # 1.65 GB measured at 1 layer: the 1.65 GB file and the tokenizer (2.04 GB at 2 layers)
# the generation attention over the clip: 21,120 queries against 64 + 21,120
# keys (165 full 128-key tiles and a ragged 64), unmasked, K and V repeated
# from 8 of the 32 heads as jnp.repeat does; held at C3_CHECK_HEADS heads over
# one key/value head
COSMOS3_KERNEL_CASES = (("c3_gen", 32, C3_GEN, C3_KEYS, 128, "c3_gen"),)
C3_CHECK_HEADS = 2
# phase 46: LTX-2 (Lightricks/LTX-2's transformer/ as the JAX preset
# LTX2Config() builds it: 48 dual-modal blocks, a 4096-wide video stream of
# 32 heads of 128 and a 2048-wide audio stream of 32 heads of 64, 128 latent
# channels each, 3840-wide caption features; 18.88B parameters) on 768 x 512
# x 121 clips (16 x 16 x 24 latents: 6,144 video tokens, the LTX-Video row's
# shape), 121 audio latent tokens in the joint step (4.84 s at 25 latent
# frames a second), 256 Gemma-2 tokens (phase 43's file, GEMMA_FILE_LAYERS of
# 26, tiled to 3840) with 180 valid where a mask rides; the seeded file at
# LTX2_FILE_BLOCKS of 48 blocks with every parameter outside them (the
# adaLN heads and caption MLPs are width: 344.6M) and the latent upsampler's
# at its published config (126.3M); the renders square at 768 px and 25
# frames (4 x 24 x 24 = 2,304 tokens; the spatial-upscale render's first
# stage at 4 x 12 x 12), the parity forward on 25 frames (4 x 16 x 24 =
# 1,536 video and 25 audio tokens); in a named run all 48 blocks in memory
L2_PROMPT = LV_PROMPT
L2_TEXT, L2_VALID = 256, 180
L2_FRAMES, L2_WIDTH, L2_HEIGHT = 121, 768, 512
L2_LATENT = ((L2_FRAMES - 1) // 8 + 1, L2_HEIGHT // 32, L2_WIDTH // 32)
L2_TOKENS = L2_LATENT[0] * L2_LATENT[1] * L2_LATENT[2]
L2_AUDIO, L2_PARITY_FRAMES, L2_PARITY_AUDIO = 121, 25, 25
L2_RENDER_SIZE, L2_RENDER_FRAMES, L2_GUIDANCE, L2_SIGMA = 768, 25, 3.0, 0.7
L2_CLIPS, L2_TRAIN_STEPS, L2_FULL_STEPS = 2, 6, 3
LTX2_FILE_BLOCKS = 1
PHASE46_WRITE_GB = 0.95  # 0.935 GB measured: the 0.73 GB transformer, the 0.13 GB upsampler, caches and outputs
# phases 3 and 7 at LTX-2's six attentions: the video self-attention (32 x
# 128 over 6,144 tokens), its prompt cross-attention against the 256 Gemma
# keys with 180 valid (query ids 1, key ids 1 / -1), a2v (6,144 video
# queries against 121 audio keys) and v2a (121 against 6,144) at 32 heads of
# 64, the audio self-attention (121 tokens: one ragged tile) and its prompt
# cross-attention; phase 3 also at the connectors' self-attention (30 x 128
# over 256 tokens, forward only: nothing trains them); held at L2_CHECK_HEADS heads
LTX2_KERNEL_CASES = (
    ("l2_video_self", 32, L2_TOKENS, L2_TOKENS, 128),
    ("l2_video_cross", 32, L2_TOKENS, L2_TEXT, 128, "l2_keys"),
    ("l2_a2v", 32, L2_TOKENS, L2_AUDIO, 64),
    ("l2_v2a", 32, L2_AUDIO, L2_TOKENS, 64),
    ("l2_audio_self", 32, L2_AUDIO, L2_AUDIO, 64),
    ("l2_audio_cross", 32, L2_AUDIO, L2_TEXT, 64, "l2_keys"),
)
LTX2_CONNECTOR_CASES = (("l2_connector", 30, L2_TEXT, L2_TEXT, 128),)
L2_CHECK_HEADS = 2
# phase 47: ACE-Step (ACE-Step/ACE-Step-v1-3.5B's transformer as the JAX preset
# ACEStepConfig() builds it: 28 Lite-LA blocks 1536 wide, 24 heads of 64, GLUMBConv
# 6,144, the 6-layer 1024-wide conformer over the 6,681-token lyric table and the
# two SSL heads; 8-channel latents of the stereo 44.1 kHz audio VAE at 512x) on
# four seeded stereo 16-bit clips of 47 s: 2,072,700 samples, 4,048 latents, the
# mel layout 16 x 253 (253 tokens); umT5 at 256 tokens (umT5-base's 768 width at
# UMT5_LAYERS of its 12 layers, its table cut to the T5 tokenizer's 32,128 rows),
# the lyric ids of ACE_LYRICS (ACE_LYRIC_IDS ids on the seeded vocab, padded to
# 128): 1 + 256 + 128 = 385 cross keys, 363 valid; the seeded file at
# ACE_FILE_BLOCKS of 28 blocks with the conformer and conditioning whole; in a
# named run all 28 blocks in memory
ACE_PROMPT = "a lighthouse song of waves and rain, slow piano and strings"
ACE_LYRICS = ("[verse]\nwaves of colour over the harbour\nthe lighthouse turns in the rain\n\n[chorus]\n"
              "hold the light, hold the night")
ACE_RATE, ACE_SECONDS, ACE_CLIPS = 44100, 47, 4
ACE_LATENTS = 4048  # the audio VAE's encode of 47 s at 44.1 kHz
ACE_TOKENS = ACE_LATENTS // 16
ACE_TEXT, ACE_LYRIC_IDS, ACE_LYRIC_KEYS = 256, 106, 128
ACE_KEYS = 1 + ACE_TEXT + ACE_LYRIC_KEYS
ACE_VALID_KEYS = 1 + ACE_TEXT + ACE_LYRIC_IDS
ACE_GUIDANCE, ACE_SIGMA = 3.0, 0.7
ACE_TRAIN_STEPS, ACE_FULL_STEPS = 6, 3
ACE_FILE_BLOCKS, UMT5_LAYERS, UMT5_VOCAB = 2, 2, 32128
PHASE47_WRITE_GB = 0.39
# phases 3 and 7 at ACE-Step's cross-attention: the 253 latent tokens against the
# 385 conditioning keys (query ids 1; key ids 1 on the speaker, caption and the
# lyric ids, -1 on the lyric pads); held at ACE_CHECK_HEADS heads
ACE_KERNEL_CASES = (("ace_cross", 24, ACE_TOKENS, ACE_KEYS, 64, "ace_keys"),)
ACE_CHECK_HEADS = 2
# phase 48: Wan-S2V (Wan-AI/Wan2.2-S2V-14B as the JAX family builds it: Wan's DiT
# at WanConfig.b14(), 5120 wide, 40 heads of 128, 40 blocks, umT5 at 512 tokens,
# each clip's audio features (64-bin log STFT frames of its same-stem WAV at 16
# kHz, cut or zero-padded to S2V_FRAMES, zero-padded to the 4,096-wide text)
# joined after the text: 512 + 128 = 640 cross keys) on two 832 x 480 x 81 clips
# (32,760 tokens; phase 42's clips and their latents linked where it ran) with
# 5 s WAVs; the seeded file at S2V_FILE_BLOCKS of 40 blocks; the render text-only
# (a validation batch carries no audio), 17 frames at 480 px square
S2V_PROMPT = WAN_PROMPT
S2V_FRAMES, S2V_AUDIO_RATE, S2V_AUDIO_SECONDS = 128, 16000, 5
S2V_KEYS = WAN_TEXT + S2V_FRAMES
S2V_FILE_BLOCKS, S2V_TRAIN_STEPS = 1, 6
S2V_RENDER_FRAMES, S2V_GUIDANCE = 17, 5.0
PHASE48_WRITE_GB = 0.73
S2V_KERNEL_CASES = (("s2v_cross", 40, WAN_TOKENS, S2V_KEYS, 128),)
S2V_CHECK_HEADS = 2
# the depth of the earlier families' seeded files in a run of every phase
# (full width; the kernels' shapes depend on width and tokens, not depth),
# cut to make room for phases 25-32 in the write budget: SD3.5 Large at 2 of
# its 38 blocks (6 before phases 31-32), AuraFlow v0.3 at 1 + 2 of its 4 + 32
# (2 + 4 before phases 39-41; both block kinds and the D = 256 shapes kept),
# Wan 2.1 T2V-1.3B at 5 of 30, LTX-Video 2B at 2 of 28 (10 and 10 before
# phases 36-38, 5 before phase 46), Chroma at 1 + 1 of
# its 19 + 38 (2 + 4 before phases 31-32, 1 + 2 before phase 45; its kernel shapes are Flux's),
# Gemma-2 2B at GEMMA_FILE_LAYERS of 26, Kandinsky 5.0
# Lite at 2 of its 32 visual blocks (16 before phases 36-38, 6 before phase 45, 3 before phase 46), SDXL's levels 1
# and 2 at 1 of their 2 and 10 transformer layers (1 + 2 + 2 since phases
# 36-38, 1 + 1 + 1 since phases 39-41; Kolors alike), Zlab-i1 at 5 of its 29
# blocks in memory (all 29 before),
# HunyuanVideo 1.5 at 3 of 54, Qwen-Image at 1 of 60 (6 and 2 before phase 45
# needed the room) and HiDream-I1 at 1 + 1
# of its 16 + 32 (4 and 2 + 2 before phases 31-32 needed the room), FLUX.2 at
# 1 + 1 of its 8 + 48, Lumina-Image 2.0 at 3 of its 26 joint blocks (6 before
# phase 45) and Gemma-2 2B at 2 of 26 layers (26 and 6 before phases 33-35 needed the room),
# LongCat-Image at 1 + 1 of 19 + 38, Z-Image-Omni at 1 of 30 layers with
# refiners 1 deep of 2; a run that names one of these phases (--phases)
# writes it at full depth where its writes leave room
SD3_CUT_BLOCKS = 2
AURA_CUT_BLOCKS = (1, 2)
WAN_CUT_BLOCKS = 5
LTX_CUT_BLOCKS = 2
CHROMA_CUT_BLOCKS = (1, 1)
K5_CUT_BLOCKS = 2
SDXL_CUT_LAYERS = (1, 1, 1)
ZL_MEMORY_BLOCKS = 5
HY_CUT_BLOCKS = 3
QI_CUT_BLOCKS = 1
HD_CUT_BLOCKS = (1, 1)
F2_CUT_BLOCKS = (1, 1)
LUMINA_CUT_BLOCKS = 3
# the most a run may write, deleted files included (45 GiB), and the margin
# below it for what this process's count does not see (the server jobs' child
# processes in phase 18, nvcc's outputs); the last phase checks the run's
# writes against the difference
RUN_WRITE_LIMIT_GB, RUN_WRITE_MARGIN_GB = 48.3, 1.0
RUN_WRITE_TARGET_GB = RUN_WRITE_LIMIT_GB - RUN_WRITE_MARGIN_GB
# phase 10: the Flux linears' (in, out): attention q/k/v and proj, single-block
# linear1 (q, k, v, mlp) and linear2, the MLP in and out, double-block AdaLN
INT8_SHAPES = ((3072, 3072), (3072, 21504), (15360, 3072), (3072, 12288), (12288, 3072), (3072, 18432))
INT8_ROWS = 4608  # 4096 image + 512 text tokens
# int8_dynamic_dot against a plain version written out here (f32 per-row
# quantize, float64 contraction and scaling, one rounding to bf16): the codes
# and the products are exact on both sides and the scaled values differ by f32
# roundings, so every element is within one bf16 ulp (at most 2^-7 of its value)
DOT_REL = 2.0 ** -7
_STARTED = time.perf_counter()
# what each family phase writes at its depth in a run of every phase (a little above
# what a run of every phase writes), for the reservations each of phases 19-32
# makes for the later phases of the run
PHASE_WRITE_GB = {19: 1.02, 20: 0.91, 21: PHASE21_WRITE_GB, 22: PHASE22_WRITE_GB, 23: PHASE23_WRITE_GB,
                  24: PHASE24_WRITE_GB, 25: PHASE25_WRITE_GB, 26: PHASE26_WRITE_GB, 27: PHASE27_WRITE_GB,
                  28: PHASE28_WRITE_GB, 29: PHASE29_WRITE_GB, 30: PHASE30_WRITE_GB, 31: PHASE31_WRITE_GB,
                  32: PHASE32_WRITE_GB, 33: PHASE33_WRITE_GB, 34: PHASE34_WRITE_GB, 35: PHASE35_WRITE_GB,
                  36: PHASE36_WRITE_GB, 37: PHASE37_WRITE_GB, 38: PHASE38_WRITE_GB, 39: PHASE39_WRITE_GB,
                  40: PHASE40_WRITE_GB, 41: PHASE41_WRITE_GB, 42: PHASE42_WRITE_GB, 43: PHASE43_WRITE_GB,
                  44: PHASE44_WRITE_GB, 45: PHASE45_WRITE_GB, 46: PHASE46_WRITE_GB, 47: PHASE47_WRITE_GB,
                  48: PHASE48_WRITE_GB}
# the phases whose files (or, for 5 and 6, whose runtime) a phase needs before
# it; 1, 2, 3 and 7 run in every run (the build, and the kernels line's times)
PHASE_NEEDS = {4: (14, 15, 16), 5: (4,), 6: (5,), 15: (14,), 16: (14,), 17: (14, 15, 16), 18: (17,),
               19: (14, 15, 16), 20: (19,), 21: (20,), 22: (20,), 23: (15, 16), 24: (15, 16), 25: (14, 15, 16),
               26: (14, 16), 27: (14, 15, 16), 28: (14, 15), 29: (14, 16), 30: (14, 15, 16, 19), 31: (),
               32: (14, 16), 33: (14, 16), 34: (14, 16), 35: (), 36: (14, 16), 37: (14, 15, 16), 38: (14, 16),
               39: (16,), 40: (), 41: (), 42: (15,), 43: (), 44: (42, 43), 45: (), 46: (), 47: (15,), 48: (15,)}
ALWAYS = (1, 2, 3, 7)
LAST_PHASE = 48
# the phases named on the command line (None: every phase) and those the run takes
RUN = {"requested": None, "phases": set(range(1, LAST_PHASE + 1))}


def named_phases(spec: str) -> set:
    """The phases a ``--phases`` spec (``1-3,14-16,25,26``) names."""
    named = set()
    for part in spec.split(","):
        low, _, high = part.strip().partition("-")
        named.update(range(int(low), int(high or low) + 1))
    if not named or min(named) < 1 or max(named) > LAST_PHASE:
        raise SystemExit(f"chip_smoke: --phases {spec!r} names no phase in 1-{LAST_PHASE}")
    return named


def with_needs(named: set) -> set:
    """``named`` with the phases they need (``PHASE_NEEDS``) and ``ALWAYS``."""
    taken, todo = set(ALWAYS), list(named)
    while todo:
        number = todo.pop()
        if number not in taken:
            taken.add(number)
            todo.extend(PHASE_NEEDS.get(number, ()))
    return taken


def _runs(number: int) -> bool:
    return number in RUN["phases"]


def _reserved(after: int) -> float:
    """What the run's family phases after ``after`` write (their reservations)."""
    return sum(gb for number, gb in PHASE_WRITE_GB.items() if number > after and _runs(number))


def _full_depth(number: int, extra_gb: float) -> bool:
    """A phase writes its full-depth file only in a run that names it
    (``--phases``) and only where the run's writes leave room for the
    ``extra_gb`` that the full depth adds, beside the phase's own and the
    later phases' reservations."""
    requested = RUN["requested"]
    return requested is not None and number in requested and \
        _written_gb() + PHASE_WRITE_GB[number] + extra_gb + _reserved(number) <= RUN_WRITE_TARGET_GB


def train_blocks() -> tuple:
    """Flux's (double, single) blocks in phases 14 (the fp8 file), 17 and 18:
    all of them in a run that names phase 17 or 18, else ``TRAIN_CUT_BLOCKS``."""
    requested = RUN["requested"] or ()
    return (19, 38) if 17 in requested or 18 in requested else TRAIN_CUT_BLOCKS


@contextlib.contextmanager
def family_depth(cls, **depth):
    """Every ``cls`` the trainer, the runtime or the registry builds inside
    the block from a config (no ``arch`` given) takes ``depth`` (fields of
    its arch, e.g. ``depth=6``): the depth of the seeded file, whose width is
    the published one."""
    init = cls.__init__

    def cut(self, config, arch=None):
        init(self, config, arch)
        if arch is None:
            self.arch = dataclasses.replace(self.arch, **depth)

    cls.__init__ = cut
    try:
        yield
    finally:
        cls.__init__ = init


def check_run_writes() -> dict:
    """The run's writes against ``RUN_WRITE_TARGET_GB`` (the last phase's check)."""
    written = _written_gb()
    if written > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"the run wrote {written:.2f} GB, past the {RUN_WRITE_TARGET_GB} GB it may write "
                           f"({RUN_WRITE_LIMIT_GB} GB on the card's machine, less {RUN_WRITE_MARGIN_GB} GB for what "
                           "this count cannot see)")
    return {"written_gb": written, "write_target_gb": RUN_WRITE_TARGET_GB}


def phase(name: str, **fields) -> None:
    """One phase's line, with the seconds since the script started (``elapsed_s``:
    a phase's seconds are the difference to the line before) and the GB the
    process has written so far (``written_gb``)."""
    fields["elapsed_s"] = time.perf_counter() - _STARTED
    fields.setdefault("written_gb", _written_gb())
    print(f"phase {name}: " + json.dumps(fields, sort_keys=True), flush=True)


def nvidia_smi() -> str:
    result = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return result.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    from simpletuner_tpu_torch.bench_cache import cuda_ms as timed

    return timed(fn, iters, warmup)


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def check_png(path: str, width: int, height: int) -> None:
    """Parse the PNG by hand: signature, IHDR, and IDAT inflating to the pixel rows."""
    with open(path, "rb") as handle:
        data = handle.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise RuntimeError(f"{path} is not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if zlib.crc32(tag + body) != struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]:
            raise RuntimeError(f"{path}: bad CRC in {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    if header is None or header[:4] != (width, height, 8, 2):
        raise RuntimeError(f"{path}: IHDR {header} is not {width}x{height} 8-bit RGB")
    if len(zlib.decompress(idat)) != height * (1 + 3 * width):
        raise RuntimeError(f"{path}: pixel data has the wrong size")


def _qkv(seed, b, h, s, d, n=3):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, h, s, d), dtype=np.float32)).to("cuda", torch.bfloat16)
            for _ in range(n)]


def _segments(batch, length, txt_valid=None, packed_at=None, pad_from=None):
    """int32 segment ids on the card: Flux T5 padding (text first, tokens
    txt_valid..TXT_LEN pad), or packed samples (1 from packed_at, pad from
    pad_from in the last batch row)."""
    import torch

    from simpletuner_tpu_torch.ops import SEGMENT_PAD_ID

    seg = torch.zeros((batch, length), dtype=torch.int32, device="cuda")
    if txt_valid is not None:
        seg[:, txt_valid:TXT_LEN] = SEGMENT_PAD_ID
    if packed_at is not None:
        seg[:, packed_at:] = 1
        seg[-1, pad_from:] = SEGMENT_PAD_ID
    return seg


# (name, (batch, heads, seq, head_dim), segment ids, (B, S, H, D) strided view):
# the Flux shape masked and not, Flux padding at a ragged S, a ragged S
# without ids, packed samples with mixed tiles, narrow heads through the
# dispatcher's strided layout
FLUX_S = TXT_LEN + (RESOLUTION // 16) ** 2
SD3_TXT = 77 + 256  # CLIP tokens, then T5-XXL's 256
SD3_S = SD3_TXT + (RESOLUTION // 16) ** 2
KERNEL_CASES = (
    ("flux_unmasked", (1, 24, FLUX_S, 128), None, False),
    ("flux_t5_padded", (1, 24, FLUX_S, 128), {"txt_valid": TXT_VALID}, False),
    ("flux_t5_padded_s4173", (1, 24, 4173, 128), {"txt_valid": TXT_VALID}, False),
    ("ragged_s1000_d64", (1, 8, 1000, 64), None, False),
    ("segments_s300_d32", (2, 4, 300, 32), {"packed_at": 130, "pad_from": 280}, False),
    ("strided_bshd_s640_d64", (1, 8, 640, 64), {"txt_valid": 40}, True),
    # head dims the wrappers zero-pad to 128 (pixart 72, lumina2 96, sana 112)
    ("ragged_s1000_d72", (1, 8, 1000, 72), None, False),
    ("t5_padded_s1000_d72", (1, 8, 1000, 72), {"txt_valid": TXT_VALID}, False),
    ("s640_d96", (1, 8, 640, 96), None, False),
    ("strided_bshd_t5_padded_s640_d96", (1, 8, 640, 96), {"txt_valid": 40}, True),
    ("s384_d112", (2, 4, 384, 112), None, False),
    ("segments_s300_d112", (2, 4, 300, 112), {"packed_at": 130, "pad_from": 280}, False),
    # SD3.5 Large at 1024 px: 38 heads of 64 over 77 CLIP + 256 T5 + 4096 image
    # tokens; 4429 is no multiple of the 128-row tiles, so the kernels run their
    # masked mode with no mask from the caller
    ("sd35_large_s4429_d64", (1, 38, SD3_S, 64), None, False),
)
# head dims timed at the Flux sequence (T5 padding masked) beside 128
PADDED_HEAD_DIMS = (72, 96, 112)


def _case_inputs(seed, shape, ids, strided, n):
    tensors = _qkv(seed, *shape, n=n)
    if strided:  # (B, S, H, D) memory, viewed as (B, H, S, D)
        tensors = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in tensors]
    seg = None if ids is None else _segments(shape[0], shape[2], **ids)
    return tensors, seg


def _sdpa_backend(fn, iters: int = 20, fused_only: bool = False):
    """(name, ms) of the fastest SDPA backend that runs ``fn`` (of flash,
    cuDNN, memory-efficient and, unless ``fused_only``, math), each timed
    over ``iters`` calls with CUDA events.  ``fused_only`` leaves out math,
    which writes the S x S scores to device memory and is never the fastest
    at a long sequence."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times = {}
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]
    for backend in backends + ([] if fused_only else [SDPBackend.MATH]):
        try:
            with sdpa_kernel([backend]):
                fn()
                times[backend.name.lower()] = cuda_ms(fn, iters)
        except RuntimeError:
            continue
    if not times:
        raise RuntimeError("no SDPA backend ran")
    return min(times.items(), key=lambda item: item[1])


def _attention_bound_ms(products, pairs, heads, dim, nbytes):
    """The larger of the tensor-core time of ``products`` S x S x D products
    over ``pairs`` attended (query, key) pairs per head (989 TFLOP/s dense
    bf16) and the time to move ``nbytes`` once (3.35 TB/s); and which bounds."""
    flop_ms = products * 2.0 * heads * pairs * dim / PEAK_BF16_FLOPS * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(flop_ms, byte_ms), "operations" if flop_ms >= byte_ms else "bytes"


def _check_forward(name: str, q, k, v, seg, errors: dict):
    """The forward kernel against its plain version on one case: out within
    two bf16 ulps of the largest reference value and ``OUT_REL_L2``, lse
    within ``LSE_ATOL``, and rows that see no key exactly 0 with lse -1e30;
    records the errors under ``name`` and returns (out, lse)."""
    import torch

    from simpletuner_tpu_torch.ops import SEGMENT_PAD_ID, flash_attention, mha_reference_lse

    out, lse = flash_attention(q, k, v, seg, seg, return_lse=True)
    ref, ref_lse = mha_reference_lse(q, k, v, seg, seg)
    torch.cuda.synchronize()
    out_err = (out.float() - ref.float()).abs().max().item()
    out_bound = OUT_REL_MAX * ref.float().abs().max().item()
    out_rel_l2, lse_err = rel_l2(out, ref), (lse - ref_lse).abs().max().item()
    if not (torch.isfinite(out.float()).all() and out_err <= out_bound and out_rel_l2 <= OUT_REL_L2
            and lse_err <= LSE_ATOL):
        raise RuntimeError(f"kernel case {name}: out err {out_err} (<= {out_bound}), out rel L2 "
                           f"{out_rel_l2} (<= {OUT_REL_L2}), lse err {lse_err} (<= {LSE_ATOL})")
    errors[name] = {"out": out_err, "out_bound": out_bound, "out_rel_l2": out_rel_l2, "lse": lse_err}
    if seg is not None:
        dead = seg == SEGMENT_PAD_ID  # rows that see no key: exactly 0 and lse -1e30
        rows, dead_lse = out.permute(0, 2, 1, 3)[dead], lse.permute(0, 2, 1)[dead]
        if rows.numel() and not ((rows == 0).all() and (dead_lse == -1e30).all()):
            raise RuntimeError(f"kernel case {name}: fully masked rows are not exactly 0 with lse -1e30")
        errors[name]["masked_rows"] = int(rows.shape[0])
    return out, lse


def kernel_cases():
    """Phase 3: the forward kernel against its plain version; returns the
    kernels-line entries of flash_fwd, of its head dim 256 instance and at
    Wan's shapes (without launches)."""
    import torch
    import torch.nn.functional as F

    from simpletuner_tpu_torch.ops import SEGMENT_PAD_ID, flash_attention, mha_reference_lse
    from simpletuner_tpu_torch.ops.flash_attention import FWD_BLOCKS, TILE_FULL, TILE_MIXED, TILE_SKIP, tile_schedule

    worst = 0.0
    errors = {}
    marks = [("start", time.perf_counter())]
    for seed, (name, shape, ids, strided) in enumerate(KERNEL_CASES):
        (q, k, v), seg = _case_inputs(seed, shape, ids, strided, 3)
        _check_forward(name, q, k, v, seg, errors)
        worst = max(worst, errors[name]["out"])
    marks.append(("cases", time.perf_counter()))

    q, k, v = _qkv(9, 1, 24, FLUX_S, 128)
    flux_seg = _segments(1, FLUX_S, txt_valid=TXT_VALID)
    classes = tile_schedule(flux_seg, flux_seg, FLUX_S, FLUX_S, *FWD_BLOCKS)
    tiles = {name: int((classes == cls).sum()) for name, cls in
             (("skip", TILE_SKIP), ("full", TILE_FULL), ("mixed", TILE_MIXED))}
    allowed = (flux_seg[0][:, None] == flux_seg[0][None, :]) & (flux_seg[0] != SEGMENT_PAD_ID)[None, :]
    sdpa_mask = allowed[None, None]
    unmasked_backend, sdpa_ms = _sdpa_backend(lambda: F.scaled_dot_product_attention(q, k, v))
    masked_backend, sdpa_masked_ms = _sdpa_backend(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask))
    with torch.no_grad():
        sdpa_out = F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)
    dead = sdpa_out[0, :, TXT_VALID:TXT_LEN].float()
    times = {
        "kernel_unmasked_ms": cuda_ms(lambda: flash_attention(q, k, v), 20),
        "kernel_masked_ms": cuda_ms(lambda: flash_attention(q, k, v, flux_seg, flux_seg), 20),
        "plain_unmasked_ms": cuda_ms(lambda: mha_reference_lse(q, k, v), 5),
        "plain_masked_ms": cuda_ms(lambda: mha_reference_lse(q, k, v, flux_seg, flux_seg), 5),
        "sdpa_unmasked_ms": sdpa_ms, "sdpa_unmasked_backend": unmasked_backend,
        "sdpa_masked_ms": sdpa_masked_ms, "sdpa_masked_backend": masked_backend,
        # SDPA gives rows that see no key the mean of V (or NaN), not 0
        "sdpa_masked_rows": {"nan": int(dead.isnan().sum()), "max_abs": float(dead.nan_to_num().abs().max())},
    }
    for dim in PADDED_HEAD_DIMS:
        qd, kd, vd = _qkv(10 + dim, 1, 24, FLUX_S, dim)
        times[f"kernel_masked_d{dim}_ms"] = cuda_ms(lambda: flash_attention(qd, kd, vd, flux_seg, flux_seg), 20)
    q3, k3, v3 = _qkv(19, 1, 38, SD3_S, 64)
    sd3_backend, sd3_sdpa_ms = _sdpa_backend(lambda: F.scaled_dot_product_attention(q3, k3, v3))
    sd3_bound, sd3_bound_by = _attention_bound_ms(2, SD3_S ** 2, 38, 64, 4 * 38 * SD3_S * 64 * 2 + 38 * SD3_S * 4)
    sd3 = {"shape": [1, 38, SD3_S, 64], "kernel_ms": cuda_ms(lambda: flash_attention(q3, k3, v3), 20),
           "plain_ms": cuda_ms(lambda: mha_reference_lse(q3, k3, v3), 5), "sdpa_ms": sd3_sdpa_ms,
           "sdpa_backend": sd3_backend, "bound_ms": sd3_bound, "bound_by": sd3_bound_by}
    sd3["share_of_bound"] = sd3_bound / sd3["kernel_ms"]
    times["sd35_large"] = sd3
    del q3, k3, v3
    marks.append(("flux_sd3", time.perf_counter()))
    times["ddpm_families"] = ddpm_forward_cases(errors)
    worst = max([worst] + [errors[name]["out"] for name in times["ddpm_families"]])
    marks.append(("ddpm_families", time.perf_counter()))
    times["head_dim_256"], fwd256_entry = d256_forward_cases(errors)
    marks.append(("head_dim_256", time.perf_counter()))
    times["wan"], wan_entries = long_forward_cases(WAN_KERNEL_CASES, WAN_CHECK_HEADS, 700, errors)
    marks.append(("wan", time.perf_counter()))
    times["ltx"], ltx_entries = long_forward_cases(LTX_KERNEL_CASES, LTX_CHECK_HEADS, 740, errors)
    marks.append(("ltx", time.perf_counter()))
    times["lumina2"], lumina_entries = long_forward_cases(LUMINA_KERNEL_CASES, LUMINA_CHECK_HEADS, 780, errors)
    marks.append(("lumina2", time.perf_counter()))
    times["kandinsky5"], k5_entries = long_forward_cases(K5_KERNEL_CASES, K5_CHECK_HEADS, 820, errors)
    marks.append(("kandinsky5", time.perf_counter()))
    times["hunyuanvideo"], hy_entries = long_forward_cases(HY_KERNEL_CASES, HY_CHECK_HEADS, 860, errors)
    marks.append(("hunyuanvideo", time.perf_counter()))
    times["qwen_image"], qi_entries = long_forward_cases(QI_KERNEL_CASES, QI_CHECK_HEADS, 900, errors)
    marks.append(("qwen_image", time.perf_counter()))
    times["hidream"], hd_entries = long_forward_cases(HD_KERNEL_CASES, HD_CHECK_HEADS, 940, errors)
    marks.append(("hidream", time.perf_counter()))
    times["flux2"], f2_entries = long_forward_cases(F2_KERNEL_CASES, F2_CHECK_HEADS, 980, errors)
    marks.append(("flux2", time.perf_counter()))
    times["kolors"], kolors_entries = long_forward_cases(KOLORS_KERNEL_CASES, KOLORS_CHECK_HEADS, 1020, errors)
    marks.append(("kolors", time.perf_counter()))
    times["longcat_image"], lc_entries = long_forward_cases(LC_KERNEL_CASES, LC_CHECK_HEADS, 1060, errors)
    marks.append(("longcat_image", time.perf_counter()))
    times["z_image_omni"], zo_entries = long_forward_cases(ZO_KERNEL_CASES, ZO_CHECK_HEADS, 1100, errors)
    marks.append(("z_image_omni", time.perf_counter()))
    times["zlab_i1"], zl_entries = long_forward_cases(ZL_KERNEL_CASES, ZL_CHECK_HEADS, 1140, errors)
    marks.append(("zlab_i1", time.perf_counter()))
    times["krea2"], k2_entries = long_forward_cases(K2_KERNEL_CASES + K2_FUSION_CASES, K2_CHECK_HEADS, 1180, errors)
    marks.append(("krea2", time.perf_counter()))
    times["cosmos"], co_entries = long_forward_cases(CO_KERNEL_CASES + AN_ADAPTER_CASES, CO_CHECK_HEADS, 1220, errors)
    marks.append(("cosmos", time.perf_counter()))
    times["omnigen"], og_entries = long_forward_cases(OG_KERNEL_CASES, OG_CHECK_HEADS, 1260, errors)
    times["omnigen"]["og_prefix_block"] = omnigen_prefix_block()
    times["ernie"], er_entries = long_forward_cases(ER_KERNEL_CASES, ER_CHECK_HEADS, 1300, errors)
    times["ideogram"], id_entries = long_forward_cases(ID_KERNEL_CASES, ID_CHECK_HEADS, 1340, errors)
    marks.append(("omnigen_ernie_ideogram", time.perf_counter()))
    times["longcat_video"], lv_entries = long_forward_cases(LV_KERNEL_CASES, LV_CHECK_HEADS, 1380, errors)
    times["sana"], sa_entries = long_forward_cases(SA_KERNEL_CASES, SA_CHECK_HEADS, 1420, errors)
    times["sanavideo"], sv_entries = long_forward_cases(SV_KERNEL_CASES, SV_CHECK_HEADS, 1460, errors)
    marks.append(("longcat_video_sana_sanavideo", time.perf_counter()))
    times["cosmos3"], c3_entries = long_forward_cases(COSMOS3_KERNEL_CASES, C3_CHECK_HEADS, 1500, errors)
    times["cosmos3"]["c3_und_block"] = cosmos3_und_block()
    marks.append(("cosmos3", time.perf_counter()))
    times["ltxvideo2"], l2_entries = long_forward_cases(LTX2_KERNEL_CASES + LTX2_CONNECTOR_CASES, L2_CHECK_HEADS,
                                                        1540, errors)
    marks.append(("ltxvideo2", time.perf_counter()))
    times["ace_step"], ace_entries = long_forward_cases(ACE_KERNEL_CASES, ACE_CHECK_HEADS, 1580, errors)
    times["wan_s2v"], s2v_entries = long_forward_cases(S2V_KERNEL_CASES, S2V_CHECK_HEADS, 1620, errors)
    marks.append(("ace_step_wan_s2v", time.perf_counter()))
    times["section_s"] = {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}
    pairs = int(allowed.sum())
    nbytes = 4 * 24 * FLUX_S * 128 * 2 + 24 * FLUX_S * 4 + 2 * FLUX_S * 4  # q, k, v, out; lse; ids
    bound_ms, bound_by = _attention_bound_ms(2, pairs, 24, 128, nbytes)
    times["bound_unmasked_ms"] = _attention_bound_ms(2, FLUX_S ** 2, 24, 128, nbytes - 2 * FLUX_S * 4)[0]
    times["bound_masked_ms"] = bound_ms
    times["kernel_unmasked_tflops"] = 4 * 24 * FLUX_S * FLUX_S * 128 / times["kernel_unmasked_ms"] / 1e9
    phase("3 kernels", shape=[1, 24, FLUX_S, 128], tol={"out_rel_max": OUT_REL_MAX, "out_rel_l2": OUT_REL_L2,
          "lse": LSE_ATOL}, errors=errors, flux_masked_tiles=tiles, attended_pairs=pairs, **times)
    return {"max_abs_err": worst, "ms": times["kernel_masked_ms"], "plain_ms": times["plain_masked_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": sdpa_masked_ms,
            "library_call": f"scaled_dot_product_attention, boolean attn_mask ({masked_backend})"}, fwd256_entry, \
        {**wan_entries, **ltx_entries, **lumina_entries, **k5_entries, **hy_entries, **qi_entries, **hd_entries,
         **f2_entries, **kolors_entries, **lc_entries, **zo_entries, **zl_entries, **k2_entries, **co_entries,
         **og_entries, **er_entries, **id_entries, **lv_entries, **sa_entries, **sv_entries, **c3_entries,
         **l2_entries, **ace_entries, **s2v_entries}


def omnigen_prefix_block() -> dict:
    """OmniGen's prefix rows at 1024 px (``OG_PREFIX`` = 121 text and time
    queries against the prefix keys, causal, the prompt pads masked as keys;
    32 heads of 96, bf16): the plain block (``prefix_attention``) timed on the
    card beside the bound of its attended pairs, and held to a float64
    causal softmax on the card (within ``OUT_REL_L2``); no kernel runs it."""
    import torch

    from simpletuner_tpu_torch.models.omnigen.transformer import prefix_attention

    gen = torch.Generator(device="cuda").manual_seed(1250)
    q, k, v = (torch.randn((1, OG_PREFIX, 32, 96), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    key_ok = torch.ones((1, OG_PREFIX), dtype=torch.bool, device="cuda")
    key_ok[:, OG_VALID:OG_TEXT] = False
    out = prefix_attention(q, k, v, key_ok)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * 96 ** -0.5
    allowed = torch.ones((OG_PREFIX, OG_PREFIX), dtype=torch.bool, device="cuda").tril()[None, None] & \
        key_ok[:, None, None, :]
    p = torch.softmax(s.masked_fill(~allowed, float("-inf")), dim=-1).nan_to_num()
    ref = torch.einsum("bhqk,bkhd->bqhd", p, v.double())
    err = rel_l2(out, ref)
    if not (torch.isfinite(out.float()).all() and err <= OUT_REL_L2):
        raise RuntimeError(f"omnigen prefix block: rel L2 {err} (<= {OUT_REL_L2})")
    pairs = int(allowed.sum())
    bound_ms, bound_by = _attention_bound_ms(2, pairs, 32, 96, 4 * OG_PREFIX * 32 * 96 * 2)
    return {"shape": [1, 32, OG_PREFIX, OG_PREFIX, 96], "plain_ms": cuda_ms(lambda: prefix_attention(q, k, v, key_ok), 5),
            "bound_ms": bound_ms, "bound_by": bound_by, "attended_pairs": pairs, "rel_l2_vs_float64": err,
            "plain_call": "models/omnigen/transformer.py::prefix_attention (f32, causal, the pads as keys)"}


def cosmos3_und_block() -> dict:
    """Cosmos3's understanding pathway at its 64 text tokens (the reasoner's
    attention has the same shape): 32 query heads of 128 against K and V
    repeated from 8, causal, no key mask, bf16: the plain block
    (``prefix_attention``) timed on the card beside the bound of its
    attended pairs, and held to a float64 causal softmax on the card (within
    ``OUT_REL_L2``); no kernel runs it (the kernels have no causal mode)."""
    import torch

    from simpletuner_tpu_torch.models.cosmos3.transformer import repeat_kv
    from simpletuner_tpu_torch.models.omnigen.transformer import prefix_attention

    gen = torch.Generator(device="cuda").manual_seed(1540)
    q = torch.randn((1, C3_TEXT, 32, 128), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (repeat_kv(torch.randn((1, C3_TEXT, 8, 128), generator=gen, device="cuda").to(torch.bfloat16), 4)
            for _ in range(2))
    out = prefix_attention(q, k, v, None)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * 128 ** -0.5
    allowed = torch.ones((C3_TEXT, C3_TEXT), dtype=torch.bool, device="cuda").tril()[None, None]
    ref = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s.masked_fill(~allowed, float("-inf")), dim=-1), v.double())
    err = rel_l2(out, ref)
    if not (torch.isfinite(out.float()).all() and err <= OUT_REL_L2):
        raise RuntimeError(f"cosmos3 understanding block: rel L2 {err} (<= {OUT_REL_L2})")
    pairs = int(allowed.sum())
    bound_ms, bound_by = _attention_bound_ms(2, pairs, 32, 128, (2 * 32 + 2 * 8) * C3_TEXT * 128 * 2)
    return {"shape": [1, 32, C3_TEXT, C3_TEXT, 128], "kv_heads": 8,
            "plain_ms": cuda_ms(lambda: prefix_attention(q, k, v, None), 5), "bound_ms": bound_ms,
            "bound_by": bound_by, "attended_pairs": pairs, "rel_l2_vs_float64": err,
            "plain_call": "models/omnigen/transformer.py::prefix_attention (f32, causal, no key mask)"}


def backward_cases():
    """Phase 7: the dq/dkv kernels against the plain backward; returns the
    kernels-line entries of flash_bwd_dq and flash_bwd_dkv, of their head
    dim 256 instances and at Wan's shapes (without launches)."""
    import torch
    import torch.nn.functional as F

    from simpletuner_tpu_torch.ops import (
        SEGMENT_PAD_ID, flash_attention, flash_backward, flash_bwd_dkv_kernel, flash_bwd_dq_kernel,
        mha_backward_reference,
    )

    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    errors = {}

    def check(name, q, k, v, do, q_seg, kv_seg, strided):
        scale = q.shape[-1] ** -0.5
        out, lse = flash_attention(q, k, v, q_seg, kv_seg, return_lse=True)
        grads = flash_backward(q, k, v, q_seg, kv_seg, out, lse, do, scale)
        refs = mha_backward_reference(q, k, v, q_seg, kv_seg, out, lse, do, scale)
        torch.cuda.synchronize()
        errors[name] = {}
        sides = zip(("dq", "dk", "dv"), grads, refs, (q_seg, kv_seg, kv_seg), (q, k, v))
        for grad_name, grad, ref, ids, like in sides:
            g, r = grad.float(), ref.float()
            err, bound, l2 = (g - r).abs().max().item(), GRAD_REL_MAX * r.abs().max().item(), rel_l2(g, r)
            if not (torch.isfinite(g).all() and r.norm() > 0 and err <= bound and l2 <= GRAD_REL_L2):
                raise RuntimeError(f"backward case {name} {grad_name}: err {err} (<= {bound}), rel L2 {l2} "
                                   f"(<= {GRAD_REL_L2})")
            # pad queries see no key and pad keys are seen by no query: exact zeros
            if ids is not None and not (grad.permute(0, 2, 1, 3)[ids == SEGMENT_PAD_ID] == 0).all():
                raise RuntimeError(f"backward case {name}: {grad_name} of padded tokens is not exactly 0")
            if strided and grad.stride() != like.stride():
                raise RuntimeError(f"backward case {name}: {grad_name} not in its input's layout")
            errors[name][grad_name] = {"err": err, "bound": bound, "rel_l2": l2}
            kernel = "flash_bwd_dq" if grad_name == "dq" else "flash_bwd_dkv"
            worst[kernel] = max(worst[kernel], err)

    marks = [("start", time.perf_counter())]
    for seed, (name, shape, ids, strided) in enumerate(KERNEL_CASES):
        (q, k, v, do), seg = _case_inputs(100 + seed, shape, ids, strided, 4)
        check(name, q, k, v, do, seg, seg, strided)
    # cross attention: queries of one segment against keys whose second and
    # fourth 128-key blocks are pad, so the dq kernel skips whole key tiles
    q, do = _qkv(120, 2, 3, 200, 64, n=2)
    k, v = _qkv(121, 2, 3, 512, 64, n=2)
    q_seg = torch.zeros((2, 200), dtype=torch.int32, device="cuda")
    kv_seg = torch.zeros((2, 512), dtype=torch.int32, device="cuda")
    kv_seg[:, 128:256] = SEGMENT_PAD_ID
    kv_seg[:, 384:] = SEGMENT_PAD_ID
    check("cross_q200_k512_pad_key_tiles_d64", q, k, v, do, q_seg, kv_seg, False)

    times = {}
    flux_seg = _segments(1, FLUX_S, txt_valid=TXT_VALID)
    allowed = (flux_seg[0][:, None] == flux_seg[0][None, :]) & (flux_seg[0] != SEGMENT_PAD_ID)[None, :]
    pairs = {"unmasked": FLUX_S ** 2, "masked": int(allowed.sum())}
    act = 24 * FLUX_S * 128 * 2
    # dq reads q, k, v, dO, lse, delta and writes dq; dkv the same inputs, writes dk and dv
    bounds = {(kernel, mode): _attention_bound_ms(products, pairs[mode], 24, 128, nbytes)
              for kernel, products, nbytes in (("dq", 3, 5 * act + 2 * 24 * FLUX_S * 4),
                                               ("dkv", 4, 6 * act + 2 * 24 * FLUX_S * 4))
              for mode in pairs}
    for mode, seg in (("unmasked", None), ("masked", flux_seg)):
        q, k, v, do = _qkv(9, 1, 24, FLUX_S, 128, n=4)
        scale = 128 ** -0.5
        out, lse = flash_attention(q, k, v, seg, seg, return_lse=True)
        delta = (out.float() * do.float()).sum(dim=-1)

        def dq():
            return flash_bwd_dq_kernel(q, k, v, seg, seg, lse, delta, do, scale)

        times[f"dq_dkv_{mode}_ms"] = cuda_ms(lambda: flash_backward(q, k, v, seg, seg, out, lse, do, scale), 10)
        times[f"dq_{mode}_ms"] = cuda_ms(dq, 10)
        times[f"dkv_{mode}_ms"] = cuda_ms(
            lambda: flash_bwd_dkv_kernel(q, k, v, seg, seg, lse, delta, do, scale), 10)
        for kernel in ("dq", "dkv"):
            times[f"bound_{kernel}_{mode}_ms"] = bounds[(kernel, mode)][0]
            times[f"{kernel}_{mode}_share_of_bound"] = bounds[(kernel, mode)][0] / times[f"{kernel}_{mode}_ms"]
        times[f"plain_{mode}_ms"] = cuda_ms(
            lambda: mha_backward_reference(q, k, v, seg, seg, out, lse, do, scale), 3)
        if seg is not None:
            if not torch.equal(dq(), dq()):
                raise RuntimeError("flash_bwd_dq is not bitwise equal over two launches at the Flux masked shape")
            times["dq_masked_bitwise_equal_over_two_launches"] = True
        # SDPA's backward: autograd.grad of its output minus its forward
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        mask = None if seg is None else allowed[None, None]

        def forward():
            return F.scaled_dot_product_attention(*leaves, attn_mask=mask)

        def forward_backward():
            return torch.autograd.grad(forward(), leaves, do)

        backend, fwd_bwd_ms = _sdpa_backend(forward_backward)
        from torch.nn.attention import SDPBackend, sdpa_kernel
        with sdpa_kernel([getattr(SDPBackend, backend.upper())]):
            times[f"sdpa_backward_{mode}_ms"] = fwd_bwd_ms - cuda_ms(forward, 20)
        times[f"sdpa_backward_{mode}_backend"] = backend
    for dim in PADDED_HEAD_DIMS:
        q, k, v, do = _qkv(20 + dim, 1, 24, FLUX_S, dim, n=4)
        out, lse = flash_attention(q, k, v, flux_seg, flux_seg, return_lse=True)
        times[f"dq_dkv_masked_d{dim}_ms"] = cuda_ms(
            lambda: flash_backward(q, k, v, flux_seg, flux_seg, out, lse, do, dim ** -0.5), 10)
    times["sd35_large"] = backward_times(29, 1, 38, SD3_S, 64)
    marks.append(("cases_flux_sd3", time.perf_counter()))
    times["ddpm_families"] = ddpm_backward_cases(check)
    marks.append(("ddpm_families", time.perf_counter()))
    worst_d128 = dict(worst)  # the head dim 256 instances have their own entries
    times["head_dim_256"], d256_entries = d256_backward_cases(check, errors)
    marks.append(("head_dim_256", time.perf_counter()))
    times["wan"], wan_entries = long_backward_cases(WAN_KERNEL_CASES, WAN_CHECK_HEADS, 720, errors)
    marks.append(("wan", time.perf_counter()))
    times["ltx"], ltx_entries = long_backward_cases(LTX_KERNEL_CASES, LTX_CHECK_HEADS, 760, errors)
    marks.append(("ltx", time.perf_counter()))
    times["lumina2"], lumina_entries = long_backward_cases(LUMINA_KERNEL_CASES, LUMINA_CHECK_HEADS, 800, errors)
    marks.append(("lumina2", time.perf_counter()))
    times["kandinsky5"], k5_entries = long_backward_cases(K5_KERNEL_CASES, K5_CHECK_HEADS, 840, errors)
    marks.append(("kandinsky5", time.perf_counter()))
    times["hunyuanvideo"], hy_entries = long_backward_cases(HY_KERNEL_CASES, HY_CHECK_HEADS, 880, errors)
    marks.append(("hunyuanvideo", time.perf_counter()))
    times["qwen_image"], qi_entries = long_backward_cases(QI_KERNEL_CASES, QI_CHECK_HEADS, 920, errors)
    marks.append(("qwen_image", time.perf_counter()))
    times["hidream"], hd_entries = long_backward_cases(HD_KERNEL_CASES, HD_CHECK_HEADS, 960, errors)
    marks.append(("hidream", time.perf_counter()))
    times["flux2"], f2_entries = long_backward_cases(F2_KERNEL_CASES, F2_CHECK_HEADS, 1000, errors)
    marks.append(("flux2", time.perf_counter()))
    times["kolors"], kolors_entries = long_backward_cases(KOLORS_KERNEL_CASES, KOLORS_CHECK_HEADS, 1040, errors)
    marks.append(("kolors", time.perf_counter()))
    times["longcat_image"], lc_entries = long_backward_cases(LC_KERNEL_CASES, LC_CHECK_HEADS, 1080, errors)
    marks.append(("longcat_image", time.perf_counter()))
    times["z_image_omni"], zo_entries = long_backward_cases(ZO_KERNEL_CASES, ZO_CHECK_HEADS, 1120, errors)
    marks.append(("z_image_omni", time.perf_counter()))
    times["zlab_i1"], zl_entries = long_backward_cases(ZL_KERNEL_CASES, ZL_CHECK_HEADS, 1160, errors)
    marks.append(("zlab_i1", time.perf_counter()))
    times["krea2"], k2_entries = long_backward_cases(K2_KERNEL_CASES, K2_CHECK_HEADS, 1200, errors)
    marks.append(("krea2", time.perf_counter()))
    times["cosmos"], co_entries = long_backward_cases(CO_KERNEL_CASES, CO_CHECK_HEADS, 1240, errors)
    marks.append(("cosmos", time.perf_counter()))
    times["omnigen"], og_entries = long_backward_cases(OG_KERNEL_CASES, OG_CHECK_HEADS, 1280, errors)
    times["ernie"], er_entries = long_backward_cases(ER_KERNEL_CASES, ER_CHECK_HEADS, 1320, errors)
    times["ideogram"], id_entries = long_backward_cases(ID_KERNEL_CASES, ID_CHECK_HEADS, 1360, errors)
    marks.append(("omnigen_ernie_ideogram", time.perf_counter()))
    times["longcat_video"], lv_entries = long_backward_cases(LV_KERNEL_CASES, LV_CHECK_HEADS, 1400, errors)
    times["sana"], sa_entries = long_backward_cases(SA_KERNEL_CASES, SA_CHECK_HEADS, 1440, errors)
    times["sanavideo"], sv_entries = long_backward_cases(SV_KERNEL_CASES, SV_CHECK_HEADS, 1480, errors)
    marks.append(("longcat_video_sana_sanavideo", time.perf_counter()))
    times["cosmos3"], c3_entries = long_backward_cases(COSMOS3_KERNEL_CASES, C3_CHECK_HEADS, 1520, errors)
    marks.append(("cosmos3", time.perf_counter()))
    times["ltxvideo2"], l2_entries = long_backward_cases(LTX2_KERNEL_CASES, L2_CHECK_HEADS, 1560, errors)
    marks.append(("ltxvideo2", time.perf_counter()))
    times["ace_step"], ace_entries = long_backward_cases(ACE_KERNEL_CASES, ACE_CHECK_HEADS, 1600, errors)
    times["wan_s2v"], s2v_entries = long_backward_cases(S2V_KERNEL_CASES, S2V_CHECK_HEADS, 1640, errors)
    marks.append(("ace_step_wan_s2v", time.perf_counter()))
    times["section_s"] = {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}
    phase("7 backward kernels", shape=[1, 24, FLUX_S, 128], tol={"grad_rel_max": GRAD_REL_MAX,
          "grad_rel_l2": GRAD_REL_L2}, errors=errors, **times)
    library = {"library_ms": times["sdpa_backward_masked_ms"],
               "library_call": "scaled_dot_product_attention backward, dq + dk + dv together, boolean attn_mask "
                               f"({times['sdpa_backward_masked_backend']})"}
    return {**{
        f"flash_bwd_{kernel}": {"max_abs_err": worst_d128[f"flash_bwd_{kernel}"], "ms": times[f"{kernel}_masked_ms"],
                                "plain_ms": times["plain_masked_ms"], "bound_ms": bounds[(kernel, "masked")][0],
                                "bound_by": bounds[(kernel, "masked")][1], **library}
        for kernel in ("dq", "dkv")
    }, **d256_entries, **wan_entries, **ltx_entries, **lumina_entries, **k5_entries, **hy_entries, **qi_entries,
        **hd_entries, **f2_entries, **kolors_entries, **lc_entries, **zo_entries, **zl_entries, **k2_entries,
        **co_entries, **og_entries, **er_entries, **id_entries, **lv_entries, **sa_entries, **sv_entries,
        **c3_entries, **l2_entries, **ace_entries, **s2v_entries}


def _ddpm_inputs(seed, heads, sq, sk, dim, n):
    """q over ``sq`` tokens, k and v over ``sk`` (and dO over ``sq`` when
    ``n`` is 4), in the (B, S, H, D) memory the UNet's and the DiT's
    dispatcher calls give the kernels."""
    tensors = _qkv(seed, 1, heads, sq, dim, n=1) + _qkv(seed + 1, 1, heads, sk, dim, n=2)
    if n == 4:
        tensors += _qkv(seed + 2, 1, heads, sq, dim, n=1)
    return [x.transpose(1, 2).contiguous().transpose(1, 2) for x in tensors]


def ddpm_cases():
    """(name, heads, query tokens, key tokens, head dim) of the DDPM families'
    attention: SDXL's six shapes at 1024 px, then the new shapes of phase 21
    (PixArt-Sigma's 1024 px self-attention at D = 72 and its cross-attention
    against 300 T5 keys; SD 2.1's 768 px level 2 (576 ragged tokens) and
    level 0; SD 1.5's 512 px level 2)."""
    for level, (heads, seq) in enumerate(SDXL_LEVELS):
        yield f"sdxl_l{level}_self", heads, seq, seq, 64
        yield f"sdxl_l{level}_cross", heads, seq, SDXL_TXT, 64
    yield from PHASE21_KERNEL_CASES


def ddpm_forward_cases(errors: dict) -> dict:
    """Phase 3 at the DDPM families' attention shapes (``ddpm_cases``): the
    forward kernel against its plain version (the bounds of the other
    cases), kernel, plain and SDPA times and the bound (D = 72 counted as 72:
    the zero-padding to 128 is the kernel's cost), and at D = 72 the kernel
    at D = 128 on the same shape beside it; at SDXL level 0's cross-attention
    also the keys as views into a buffer whose rows 77-127 of each head hold
    NaN: the 128-key tile runs past each head's keys, and those rows must
    come back as zeros or be masked (0 x NaN is NaN), so the output is
    bitwise the contiguous one."""
    import torch
    import torch.nn.functional as F

    from simpletuner_tpu_torch.ops import flash_attention, mha_reference_lse

    cases = {}
    for seed, (name, heads, sq, sk, dim) in enumerate(ddpm_cases()):
        q, k, v = _ddpm_inputs(300 + 2 * seed, heads, sq, sk, dim, 3)
        out, _ = _check_forward(name, q, k, v, None, errors)
        if name == "sdxl_l0_cross":
            buffers = [torch.full((1, heads, 128, dim), float("nan"), dtype=torch.bfloat16, device="cuda")
                       for _ in range(2)]
            for buf, x in zip(buffers, (k, v)):
                buf[:, :, :sk] = x
            if not torch.equal(flash_attention(q, buffers[0][:, :, :sk], buffers[1][:, :, :sk]), out):
                raise RuntimeError(f"kernel case {name}: keys past a head's 77 rows reached the output")
            errors[name]["nan_padded_keys_bitwise"] = True
        backend, sdpa_ms = _sdpa_backend(lambda: F.scaled_dot_product_attention(q, k, v))
        nbytes = 2 * heads * (sq + sk) * dim * 2 + heads * sq * 4  # q, out; k, v; lse
        bound, bound_by = _attention_bound_ms(2, sq * sk, heads, dim, nbytes)
        kernel_ms = cuda_ms(lambda: flash_attention(q, k, v), 20)
        cases[name] = {"shape": [1, heads, sq, sk, dim], "kernel_ms": kernel_ms,
                       "plain_ms": cuda_ms(lambda: mha_reference_lse(q, k, v), 5), "sdpa_ms": sdpa_ms,
                       "sdpa_backend": backend, "bound_ms": bound, "bound_by": bound_by,
                       "share_of_bound": bound / kernel_ms}
        if dim != 64 and dim < 128:  # the same shape at D = 128: what the zero-padding costs
            wide = _ddpm_inputs(300 + 2 * seed, heads, sq, sk, 128, 3)
            cases[name]["kernel_d128_ms"] = cuda_ms(lambda: flash_attention(*wide), 20)
            del wide
        del q, k, v, out
    return cases


def ddpm_backward_cases(check) -> dict:
    """Phase 7 at the DDPM families' attention shapes (``ddpm_cases``): dq, dk
    and dv against the plain backward (``check``, in the dispatcher's layout),
    the dq and dkv kernels' times, the plain backward's and SDPA's, the
    bounds and shares."""
    import torch
    import torch.nn.functional as F

    from simpletuner_tpu_torch.ops import (
        flash_attention, flash_bwd_dkv_kernel, flash_bwd_dq_kernel, mha_backward_reference,
    )

    cases = {}
    for seed, (name, heads, sq, sk, dim) in enumerate(ddpm_cases()):
        q, k, v, do = _ddpm_inputs(400 + 2 * seed, heads, sq, sk, dim, 4)
        check(name, q, k, v, do, None, None, True)
        scale = dim ** -0.5
        out, lse = flash_attention(q, k, v, return_lse=True)
        delta = (out.float() * do.float()).sum(dim=-1)
        q_act, k_act, stats = heads * sq * dim * 2, heads * sk * dim * 2, 2 * heads * sq * 4
        times = {"shape": [1, heads, sq, sk, dim]}
        # dq reads q, k, v, dO, lse, delta and writes dq; dkv reads the same and writes dk, dv
        for kernel, products, nbytes, fn in (
                ("dq", 3, 3 * q_act + 2 * k_act + stats,
                 lambda: flash_bwd_dq_kernel(q, k, v, None, None, lse, delta, do, scale)),
                ("dkv", 4, 2 * q_act + 4 * k_act + stats,
                 lambda: flash_bwd_dkv_kernel(q, k, v, None, None, lse, delta, do, scale))):
            times[f"{kernel}_ms"] = cuda_ms(fn, 10)
            times[f"bound_{kernel}_ms"], times[f"bound_{kernel}_by"] = _attention_bound_ms(
                products, sq * sk, heads, dim, nbytes)
            times[f"{kernel}_share_of_bound"] = times[f"bound_{kernel}_ms"] / times[f"{kernel}_ms"]
        times["plain_ms"] = cuda_ms(lambda: mha_backward_reference(q, k, v, None, None, out, lse, do, scale), 3)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

        def forward():
            return F.scaled_dot_product_attention(*leaves)

        backend, fwd_bwd_ms = _sdpa_backend(lambda: torch.autograd.grad(forward(), leaves, do))
        from torch.nn.attention import SDPBackend, sdpa_kernel
        with sdpa_kernel([getattr(SDPBackend, backend.upper())]):
            times["sdpa_backward_ms"] = fwd_bwd_ms - cuda_ms(forward, 20)
        times["sdpa_backward_backend"] = backend
        cases[name] = times
        del q, k, v, do, out, leaves
    return cases


def backward_times(seed: int, batch: int, heads: int, seq: int, dim: int, deterministic: bool = False) -> dict:
    """Phase 7 at one self-attention shape, no caller mask (SD3.5 Large's
    (1, 38, 4429, 64), AuraFlow's (1, 12, 4360, 256)): dq, dkv, the whole
    kernel backward, the plain backward and SDPA's, with the bounds and each
    kernel's share of its bound; with ``deterministic`` also dq bitwise equal
    over two launches."""
    import torch
    import torch.nn.functional as F

    from simpletuner_tpu_torch.ops import flash_attention, flash_backward, flash_bwd_dkv_kernel, flash_bwd_dq_kernel
    from simpletuner_tpu_torch.ops import mha_backward_reference

    q, k, v, do = _qkv(seed, batch, heads, seq, dim, n=4)
    scale = dim ** -0.5
    out, lse = flash_attention(q, k, v, return_lse=True)
    delta = (out.float() * do.float()).sum(dim=-1)
    act, stats = batch * heads * seq * dim * 2, 2 * batch * heads * seq * 4
    times = {"shape": [batch, heads, seq, dim]}
    for kernel, products, nbytes, fn in (
            ("dq", 3, 5 * act + stats, lambda: flash_bwd_dq_kernel(q, k, v, None, None, lse, delta, do, scale)),
            ("dkv", 4, 6 * act + stats, lambda: flash_bwd_dkv_kernel(q, k, v, None, None, lse, delta, do, scale))):
        times[f"{kernel}_ms"] = cuda_ms(fn, 10)
        times[f"bound_{kernel}_ms"], times[f"bound_{kernel}_by"] = _attention_bound_ms(
            products, batch * seq ** 2, heads, dim, nbytes)
        times[f"{kernel}_share_of_bound"] = times[f"bound_{kernel}_ms"] / times[f"{kernel}_ms"]
    if deterministic:
        first = flash_bwd_dq_kernel(q, k, v, None, None, lse, delta, do, scale)
        if not torch.equal(first, flash_bwd_dq_kernel(q, k, v, None, None, lse, delta, do, scale)):
            raise RuntimeError(f"flash_bwd_dq is not bitwise equal over two launches at {times['shape']}")
        times["dq_bitwise_equal_over_two_launches"] = True
    times["dq_dkv_ms"] = cuda_ms(lambda: flash_backward(q, k, v, None, None, out, lse, do, scale), 10)
    times["plain_ms"] = cuda_ms(lambda: mha_backward_reference(q, k, v, None, None, out, lse, do, scale), 3)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

    def forward():
        return F.scaled_dot_product_attention(*leaves)

    backend, fwd_bwd_ms = _sdpa_backend(lambda: torch.autograd.grad(forward(), leaves, do))
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel([getattr(SDPBackend, backend.upper())]):
        times["sdpa_backward_ms"] = fwd_bwd_ms - cuda_ms(forward, 20)
    times["sdpa_backward_backend"] = backend
    return times


def _attended_pairs(seg, length: int) -> int:
    """(query, key) pairs that attend under ``seg`` (None: all), summed over the batch."""
    from simpletuner_tpu_torch.ops import SEGMENT_PAD_ID

    if seg is None:
        return length * length
    return int(((seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] != SEGMENT_PAD_ID)).sum())


def d256_forward_cases(errors: dict) -> tuple:
    """Phase 3 at head dim 256 (``D256_CASES``): the forward kernel against its
    plain version (the bounds of the other cases), rows that see no key
    exactly 0 with lse -1e30, and each case's kernel, plain and SDPA times
    (with the ids as a boolean attn_mask where there are ids) and its bound
    (over the attended pairs; D = 192 counted as 192).  Returns the cases and
    the kernels-line entry of the head dim 256 forward at AuraFlow's shape."""
    import torch.nn.functional as F

    from simpletuner_tpu_torch.ops import SEGMENT_PAD_ID, flash_attention, mha_reference_lse

    cases, worst = {}, 0.0
    for seed, (name, shape, ids) in enumerate(D256_CASES):
        (q, k, v), seg = _case_inputs(500 + seed, shape, ids, False, 3)
        _check_forward(name, q, k, v, seg, errors)
        worst = max(worst, errors[name]["out"])
        mask = None
        if seg is not None:
            mask = ((seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] != SEGMENT_PAD_ID))[:, None]
        batch, heads, seq, dim = shape
        nbytes = 4 * batch * heads * seq * dim * 2 + batch * heads * seq * 4 + (0 if seg is None else 2 * seq * 4)
        bound, bound_by = _attention_bound_ms(2, _attended_pairs(seg, seq), heads, dim, nbytes)
        backend, sdpa_ms = _sdpa_backend(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        kernel_ms = cuda_ms(lambda: flash_attention(q, k, v, seg, seg), 20)
        cases[name] = {"shape": list(shape), "kernel_ms": kernel_ms, "bound_ms": bound, "bound_by": bound_by,
                       "share_of_bound": bound / kernel_ms, "sdpa_ms": sdpa_ms, "sdpa_backend": backend,
                       "plain_ms": cuda_ms(lambda: mha_reference_lse(q, k, v, seg, seg), 5)}
        del q, k, v, mask
    aura = cases["auraflow_s4360_d256"]
    return cases, {"max_abs_err": worst, "ms": aura["kernel_ms"], "plain_ms": aura["plain_ms"],
                   "bound_ms": aura["bound_ms"], "bound_by": aura["bound_by"], "library_ms": aura["sdpa_ms"],
                   "library_call": f"scaled_dot_product_attention ({aura['sdpa_backend']})"}


def d256_backward_cases(check, errors: dict) -> tuple:
    """Phase 7 at head dim 256: dq, dk and dv of ``D256_CASES`` and of 200
    queries against 512 keys whose 64-key tiles 2-3 and 6-7 are pad (the dq
    kernel's skip tiles), against the plain backward (``check``); dq bitwise
    equal over two launches at AuraFlow's shape; at AuraFlow's shape and at
    4096 tokens the dq and dkv kernels' times, the plain backward's and
    SDPA's, the bounds and shares (``backward_times``).  Returns those times
    and the kernels-line entries of the head dim 256 dq and dkv at AuraFlow's
    shape."""
    import torch

    from simpletuner_tpu_torch.ops import SEGMENT_PAD_ID

    for seed, (name, shape, ids) in enumerate(D256_CASES):
        (q, k, v, do), seg = _case_inputs(600 + seed, shape, ids, False, 4)
        check(name, q, k, v, do, seg, seg, False)
    q, do = _qkv(620, 2, 3, 200, 256, n=2)
    k, v = _qkv(621, 2, 3, 512, 256, n=2)
    q_seg = torch.zeros((2, 200), dtype=torch.int32, device="cuda")
    kv_seg = torch.zeros((2, 512), dtype=torch.int32, device="cuda")
    kv_seg[:, 128:256] = SEGMENT_PAD_ID
    kv_seg[:, 384:] = SEGMENT_PAD_ID
    check("cross_q200_k512_pad_key_tiles_d256", q, k, v, do, q_seg, kv_seg, False)
    names = [name for name, _, _ in D256_CASES] + ["cross_q200_k512_pad_key_tiles_d256"]
    worst = {kernel: max(errors[name][grad]["err"] for name in names for grad in grads)
             for kernel, grads in (("dq", ("dq",)), ("dkv", ("dk", "dv")))}

    cases = {name: backward_times(630 + seed, *shape, deterministic=name == "auraflow_s4360_d256")
             for seed, (name, shape, _) in enumerate(D256_CASES[:2])}
    aura = cases["auraflow_s4360_d256"]
    library = {"library_ms": aura["sdpa_backward_ms"],
               "library_call": f"scaled_dot_product_attention backward, dq + dk + dv together "
                               f"({aura['sdpa_backward_backend']})"}
    return cases, {f"flash_bwd_{kernel}_d256": {
        "max_abs_err": worst[kernel], "ms": aura[f"{kernel}_ms"], "plain_ms": aura["plain_ms"],
        "bound_ms": aura[f"bound_{kernel}_ms"], "bound_by": aura[f"bound_{kernel}_by"], **library}
        for kernel in ("dq", "dkv")}



def _long_inputs(seed, heads, sq, sk, dim, n, batch=1):
    """``_ddpm_inputs`` drawn on the card (a seeded CUDA generator): q (and
    dO when ``n`` is 4) over ``sq`` tokens, k and v over ``sk``, bf16 views of
    (B, S, H, D) memory; drawing Wan's 40-head tensors on the host would take
    seconds each."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(length):
        return torch.randn((batch, length, heads, dim), generator=gen, device="cuda").to(
            torch.bfloat16).transpose(1, 2)

    tensors = [draw(sq), draw(sk), draw(sk)]
    return tensors + [draw(sq)] if n == 4 else tensors


def _by_heads(fn, *tensors):
    """``fn`` over one head at a time (every tensor's dim 1), the results
    joined on that dim: the plain version at a head count whose S x S scores
    do not fit at once."""
    import torch

    parts = [fn(*(x[:, h:h + 1] for x in tensors)) for h in range(tensors[0].shape[1])]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(list(group), dim=1) for group in zip(*parts))
    return torch.cat(parts, dim=1)


def _case_segments(length: int, plane):
    """A long case's segment ids on the card for ``length`` tokens, or None
    when ``plane`` is None.  An int is Lumina2's caption plane: the first
    ``LUMINA_CAP`` tokens a caption with ``plane`` of them valid, 1 on the
    valid caption and on every later token, 0 on the caption's pads (the
    JAX module's ids, not the pad id -1).  "hy_joint" is HunyuanVideo's joint
    plane (``HY_VIDEO`` video tokens at 0, then ``HY_TEXT`` Qwen and
    ``HY_TEXT2`` ByT5 tokens, ``HY_QWEN_VALID`` and ``HY_BYT5_VALID`` of them
    valid at 0, their pads at -1) and "hy_refiner" its refiner's (the Qwen
    caption alone); "ones" is every token at 1 (Z-Image-Omni's joint ids)."""
    import torch

    if plane is None:
        return None
    seg = torch.zeros((1, length), dtype=torch.int32, device="cuda")
    if plane == "ones":
        seg += 1
    elif plane == "hy_refiner":
        seg[:, HY_QWEN_VALID:] = -1
    elif plane == "hy_joint":
        seg[:, HY_VIDEO + HY_QWEN_VALID:HY_VIDEO + HY_TEXT] = -1
        seg[:, HY_VIDEO + HY_TEXT + HY_BYT5_VALID:] = -1
    else:
        seg += 1
        seg[:, plane:LUMINA_CAP] = 0
    return seg


def _case_planes(sq: int, sk: int, plane):
    """A long case's (query, key) segment ids: ``_case_segments``'s plane on
    both sides, or for "zl_joint" Zlab-i1's joint call: every query at 1, the
    ``LC_IMG`` image keys and the first ``ZL_VALID`` text keys at 1 and the
    other text keys at 0 (the text mask as the key ids); for "k2_joint" and
    "k2_refiner" Krea-2's: every query at 1, the first ``K2_VALID`` of the
    ``K2_TEXT`` text keys (first in the sequence) and every image key at 1,
    the text pads at -1; for "og_keys" OmniGen's image-row call: every query
    at 1, the first ``OG_VALID`` of the ``OG_TEXT`` prompt keys, the time key
    and every image key at 1, the prompt pads at -1; for "er_joint" ERNIE's:
    every query at 1, the ``LC_IMG`` image keys and the first ``ER_VALID``
    text keys at 1, the text pads at -1; for "id_joint" Ideogram's: the text
    mask as the ids of both sides, the first ``ID_VALID`` of the ``ID_TEXT``
    text tokens and every image token at 1, the text pads at 0; for
    "lv_keys", "sv_keys" and "l2_keys" LongCat-Video's, Sana-Video's and
    LTX-2's prompt cross-attention: every query at 1, the first ``LV_VALID``
    / ``SV_VALID`` / ``L2_VALID`` caption keys at 1 and the pads at -1;
    "c3_gen" Cosmos3's generation attention, unmasked; for "ace_keys" ACE-Step's
    cross-attention: every query at 1, the first ``ACE_VALID_KEYS`` keys (the
    speaker, the caption and the lyric ids) at 1 and the lyric pads at -1."""
    import torch

    if plane == "c3_gen":
        return None, None
    if plane == "id_joint":
        seg = torch.ones((1, sq), dtype=torch.int32, device="cuda")
        seg[:, ID_VALID:ID_TEXT] = 0
        return seg, seg
    if plane not in ("zl_joint", "k2_joint", "k2_refiner", "og_keys", "er_joint", "lv_keys", "sv_keys", "l2_keys",
                     "ace_keys"):
        seg = _case_segments(sq, plane)
        return seg, seg
    kv = torch.ones((1, sk), dtype=torch.int32, device="cuda")
    if plane == "zl_joint":
        kv[:, LC_IMG + ZL_VALID:] = 0
    elif plane == "og_keys":
        kv[:, OG_VALID:OG_TEXT] = -1
    elif plane == "er_joint":
        kv[:, LC_IMG + ER_VALID:] = -1
    elif plane in ("lv_keys", "sv_keys", "l2_keys", "ace_keys"):
        kv[:, {"lv_keys": LV_VALID, "sv_keys": SV_VALID, "l2_keys": L2_VALID, "ace_keys": ACE_VALID_KEYS}[plane]:] = -1
    else:
        kv[:, K2_VALID:K2_TEXT] = -1
    return torch.ones((1, sq), dtype=torch.int32, device="cuda"), kv


def _repeat_kv(plane, k, v):
    """Krea-2's joint K and V (the "k2_joint" plane) and Cosmos3's
    generation K and V ("c3_gen") as their attentions hand them over: a
    quarter of the heads (one head below four) repeated as ``jnp.repeat``
    does, head h reading head h // 4, in the (B, S, H, D) memory layout;
    other planes' K and V as they are."""
    if plane not in ("k2_joint", "c3_gen"):
        return k, v
    heads = k.shape[1]
    kv_heads = max(heads // 4, 1)
    return tuple(x.transpose(1, 2)[:, :, :kv_heads].repeat_interleave(heads // kv_heads, dim=2).transpose(1, 2)
                 for x in (k, v))


def _segment_pairs(q_seg, kv_seg, sq: int, sk: int) -> int:
    """(query, key) pairs the segment planes let attend: over each id, its
    query count times its key count (a pad at -1 attends and is attended by
    nothing)."""
    import torch

    if q_seg is None:
        return sq * sk
    q, kv = q_seg[0].long(), kv_seg[0].long()
    size = int(max(q.max(), kv.max())) + 1
    return int((torch.bincount(q[q >= 0], minlength=size) * torch.bincount(kv[kv >= 0], minlength=size)).sum())


def long_forward_cases(cases, check_heads: int, seed: int, errors: dict) -> tuple:
    """Phase 3 at a family's long shapes (``WAN_KERNEL_CASES``,
    ``LTX_KERNEL_CASES``, ``K5_KERNEL_CASES``, ``LUMINA_KERNEL_CASES`` and
    ``HY_KERNEL_CASES`` with their segment planes, ``_case_segments``; the
    dispatcher's (B, S, H, D) layout): the forward
    kernel against its plain version at ``check_heads`` heads (the bounds of
    the other cases, the plain version head by head); at the full head count
    the kernel's time, the plain version's (head by head), SDPA's fastest
    fused backend's (a boolean mask where the case has segments) and the
    bound, reckoned at the case's head dim over the attended pairs.  Returns
    the cases and the kernels-line entries (without launches)."""
    import torch
    import torch.nn.functional as F

    from simpletuner_tpu_torch.ops import flash_attention, mha_reference_lse

    cases_out, entries = {}, {}
    for index, (name, heads, sq, sk, dim, *valid) in enumerate(cases):
        t0 = time.perf_counter()
        batch = valid[1] if len(valid) > 1 else 1  # a case of many short sequences
        q_seg, kv_seg = _case_planes(sq, sk, valid[0] if valid else None)
        mask = None if q_seg is None else (q_seg[0][:, None] == kv_seg[0][None, :])[None, None]

        def plain(q, k, v):
            return mha_reference_lse(q, k, v, q_seg, kv_seg)

        checked = min(heads, check_heads)
        q, k, v = _long_inputs(seed + 2 * index, checked, sq, sk, dim, 3, batch)
        k, v = _repeat_kv(valid[0] if valid else None, k, v)
        out, lse = flash_attention(q, k, v, q_seg, kv_seg, return_lse=True)
        ref, ref_lse = _by_heads(plain, q, k, v)
        torch.cuda.synchronize()
        err, bound = (out.float() - ref.float()).abs().max().item(), OUT_REL_MAX * ref.float().abs().max().item()
        l2, lse_err = rel_l2(out, ref), (lse - ref_lse).abs().max().item()
        if not (torch.isfinite(out.float()).all() and err <= bound and l2 <= OUT_REL_L2 and lse_err <= LSE_ATOL):
            raise RuntimeError(f"kernel case {name}: out err {err} (<= {bound}), rel L2 {l2} (<= {OUT_REL_L2}), "
                               f"lse err {lse_err} (<= {LSE_ATOL})")
        errors[name] = {"heads_checked": checked, "out": err, "out_bound": bound, "out_rel_l2": l2, "lse": lse_err}
        del q, k, v, out, lse, ref, ref_lse
        q, k, v = _long_inputs(seed + 10 + 2 * index, heads, sq, sk, dim, 3, batch)
        k, v = _repeat_kv(valid[0] if valid else None, k, v)
        backend, sdpa_ms = _sdpa_backend(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), 5,
                                         fused_only=True)
        nbytes = batch * (2 * heads * (sq + sk) * dim * 2 + heads * sq * 4) + (0 if q_seg is None else (sq + sk) * 4)
        pairs = batch * _segment_pairs(q_seg, kv_seg, sq, sk)
        bound_ms, bound_by = _attention_bound_ms(2, pairs, heads, dim, nbytes)  # q, out; k, v; lse; ids
        kernel_ms = cuda_ms(lambda: flash_attention(q, k, v, q_seg, kv_seg), 5)
        plain_ms = cuda_ms(lambda: _by_heads(plain, q, k, v), 1, warmup=0)  # one head at a time: the first warms
        cases_out[name] = {"shape": [batch, heads, sq, sk, dim], "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                           "sdpa_ms": sdpa_ms, "sdpa_backend": backend, "bound_ms": bound_ms, "bound_by": bound_by,
                           "share_of_bound": bound_ms / kernel_ms, "attended_pairs": pairs,
                           "segment_plane": valid[0] if valid else None, "seconds": time.perf_counter() - t0}
        entries[f"flash_fwd_{name}"] = {
            "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sdpa_ms, "library_call": f"scaled_dot_product_attention ({backend}"
                                                   f"{'' if q_seg is None else ', boolean attn_mask'})",
            "shape": [batch, heads, sq, sk, dim], "max_abs_err_heads": checked,
            "plain_call": "mha_reference_lse, one head at a time"}
        del q, k, v, mask
        torch.cuda.empty_cache()
    return cases_out, entries


def long_backward_cases(cases, check_heads: int, seed: int, errors: dict) -> tuple:
    """Phase 7 at a video family's shapes: dq, dk and dv from the kernels
    against the plain backward (head by head) at ``check_heads`` heads, in
    the dispatcher's layout; at the full head count the dq and dkv kernels'
    times, the plain backward's (head by head), SDPA's backward (dq + dk +
    dv, its fastest fused backend) and the bounds and shares.  Returns the
    cases and the kernels-line entries (without launches)."""
    import torch
    import torch.nn.functional as F

    from simpletuner_tpu_torch.ops import (
        flash_attention, flash_backward, flash_bwd_dkv_kernel, flash_bwd_dq_kernel, mha_backward_reference,
    )

    cases_out, entries = {}, {}
    for index, (name, heads, sq, sk, dim, *valid) in enumerate(cases):
        t0 = time.perf_counter()
        scale = dim ** -0.5
        q_seg, kv_seg = _case_planes(sq, sk, valid[0] if valid else None)
        mask = None if q_seg is None else (q_seg[0][:, None] == kv_seg[0][None, :])[None, None]

        def plain(q, k, v, out, lse, do):
            return mha_backward_reference(q, k, v, q_seg, kv_seg, out, lse, do, scale)

        checked = min(heads, check_heads)
        q, k, v, do = _long_inputs(seed + 2 * index, checked, sq, sk, dim, 4)
        k, v = _repeat_kv(valid[0] if valid else None, k, v)
        out, lse = flash_attention(q, k, v, q_seg, kv_seg, return_lse=True)
        grads = flash_backward(q, k, v, q_seg, kv_seg, out, lse, do, scale)
        refs = _by_heads(plain, q, k, v, out, lse, do)
        torch.cuda.synchronize()
        errors[name + "_backward"] = {"heads_checked": checked}
        worst = {"dq": 0.0, "dkv": 0.0}
        for grad_name, grad, ref in zip(("dq", "dk", "dv"), grads, refs):
            g, r = grad.float(), ref.float()
            err, bound, l2 = (g - r).abs().max().item(), GRAD_REL_MAX * r.abs().max().item(), rel_l2(g, r)
            if not (torch.isfinite(g).all() and r.norm() > 0 and err <= bound and l2 <= GRAD_REL_L2):
                raise RuntimeError(f"backward case {name} {grad_name}: err {err} (<= {bound}), rel L2 {l2} "
                                   f"(<= {GRAD_REL_L2})")
            errors[name + "_backward"][grad_name] = {"err": err, "bound": bound, "rel_l2": l2}
            kernel = "dq" if grad_name == "dq" else "dkv"
            worst[kernel] = max(worst[kernel], err)
        del q, k, v, do, out, lse, grads, refs
        torch.cuda.empty_cache()

        q, k, v, do = _long_inputs(seed + 10 + 2 * index, heads, sq, sk, dim, 4)
        k, v = _repeat_kv(valid[0] if valid else None, k, v)
        out, lse = flash_attention(q, k, v, q_seg, kv_seg, return_lse=True)
        delta = (out.float() * do.float()).sum(dim=-1)
        q_act, k_act = heads * sq * dim * 2, heads * sk * dim * 2
        stats = 2 * heads * sq * 4 + (0 if q_seg is None else (sq + sk) * 4)
        pairs = _segment_pairs(q_seg, kv_seg, sq, sk)
        times = {"shape": [1, heads, sq, sk, dim], "attended_pairs": pairs}
        for kernel, products, nbytes, fn in (
                ("dq", 3, 3 * q_act + 2 * k_act + stats,
                 lambda: flash_bwd_dq_kernel(q, k, v, q_seg, kv_seg, lse, delta, do, scale)),
                ("dkv", 4, 2 * q_act + 4 * k_act + stats,
                 lambda: flash_bwd_dkv_kernel(q, k, v, q_seg, kv_seg, lse, delta, do, scale))):
            times[f"{kernel}_ms"] = cuda_ms(fn, 3)
            times[f"bound_{kernel}_ms"], times[f"bound_{kernel}_by"] = _attention_bound_ms(
                products, pairs, heads, dim, nbytes)
            times[f"{kernel}_share_of_bound"] = times[f"bound_{kernel}_ms"] / times[f"{kernel}_ms"]
        times["plain_ms"] = cuda_ms(lambda: _by_heads(plain, q, k, v, out, lse, do), 1, warmup=0)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

        def forward():
            return F.scaled_dot_product_attention(*leaves, attn_mask=mask)

        backend, fwd_bwd_ms = _sdpa_backend(lambda: torch.autograd.grad(forward(), leaves, do), 3, fused_only=True)
        from torch.nn.attention import SDPBackend, sdpa_kernel
        with sdpa_kernel([getattr(SDPBackend, backend.upper())]):
            times["sdpa_backward_ms"] = fwd_bwd_ms - cuda_ms(forward, 3)
        times["sdpa_backward_backend"] = backend
        times["seconds"] = time.perf_counter() - t0
        cases_out[name] = times
        for kernel in ("dq", "dkv"):
            entries[f"flash_bwd_{kernel}_{name}"] = {
                "max_abs_err": worst[kernel], "ms": times[f"{kernel}_ms"], "plain_ms": times["plain_ms"],
                "bound_ms": times[f"bound_{kernel}_ms"], "bound_by": times[f"bound_{kernel}_by"],
                "library_ms": times["sdpa_backward_ms"],
                "library_call": f"scaled_dot_product_attention backward, dq + dk + dv together ({backend}"
                                f"{'' if q_seg is None else ', boolean attn_mask'})",
                "shape": [1, heads, sq, sk, dim], "max_abs_err_heads": checked,
                "plain_call": "mha_backward_reference (whole backward), one head at a time"}
        del q, k, v, do, out, lse, delta, leaves, mask
        torch.cuda.empty_cache()
    return cases_out, entries

@contextlib.contextmanager
def record_backward_norms(norms, calls: int):
    """Append the norms of dO and of dq/dk/dv at the first ``calls`` flash
    backward calls (the warm-up steps; the timed steps run unprobed)."""
    import torch

    flash = sys.modules["simpletuner_tpu_torch.ops.flash_attention"]
    plain = flash.flash_backward

    def recording(*args):
        grads = plain(*args)
        if len(norms) < calls:
            norms.append(torch.stack([args[7].float().norm()] + [g.float().norm() for g in grads]))
        return grads

    flash.flash_backward = recording
    try:
        yield
    finally:
        flash.flash_backward = plain


# phase 8 runs: (label, flagship keyword arguments); the first is the JAX flagship
TRAIN_RUNS = (
    ("int8 attn", dict(quant="int8", quantized_matmul="full", remat_policy="attn")),
    ("int4 attn", dict(quant="int4", quantized_matmul="full", remat_policy="attn")),
    ("bf16 attn", dict(quant="none", quantized_matmul="off", remat_policy="attn")),
    ("bf16 full", dict(quant="none", quantized_matmul="off", remat_policy="full")),
)


def train_steps(kernels) -> None:
    """Phase 8: the eager flagship LoRA step in each of TRAIN_RUNS."""
    import torch

    from simpletuner_tpu_torch.bench import flagship

    blocks = 19 + 38
    # attn saves the single blocks' flash outputs; full recomputes every block's
    expected_fwd = {"attn": blocks + 19, "full": 2 * blocks}
    counts = {}
    for label, kwargs in TRAIN_RUNS:
        policy = kwargs["remat_policy"]
        norms = []
        for kernel in kernels:
            kernel.launches = 0
        # the first run (phase 12's step) 2 warm-up and 2 timed steps, the
        # others 1 and 1 (2 and 2 before phases 39-41); the first is profiled
        # in a run that names phase 8 (phase 12 profiles its graphed replay)
        first = label == TRAIN_RUNS[0][0]
        warmup = 2 if first else 1
        profile = first and 8 in (RUN["requested"] or ())
        with record_backward_norms(norms, calls=warmup * blocks):
            result = flagship(steps=warmup, warmup=warmup, profile=profile, graph=False, **kwargs)
        counts[label] = {kernel.name: kernel.launches for kernel in kernels}
        per_step = result["launches_per_step"]
        norms = torch.stack(norms).cpu()
        losses = result["losses"]
        problems = []
        if not all(map(math.isfinite, losses)) or result["skipped_nonfinite"]:
            problems.append(f"non-finite losses {losses}")
        if not result["lora_delta"] > 0:
            problems.append("the LoRA weights did not move")
        if per_step != {"flash_fwd": expected_fwd[policy], "flash_bwd_dq": blocks, "flash_bwd_dkv": blocks}:
            problems.append(f"launches per step {per_step}")
        if len(norms) != warmup * blocks or not (norms > 0).all():
            problems.append(f"zero dO/dq/dk/dv reaching the kernels: {norms.min(dim=0).values.tolist()}")
        if result["quant"] != kwargs["quant"] or result["quantized_matmul"] != kwargs["quantized_matmul"]:
            problems.append(f"the run used quant={result['quant']}, quantized_matmul={result['quantized_matmul']}")
        if (kwargs["quant"] != "none") != (result["int_mm_per_step"] > 0):
            problems.append(f"{result['int_mm_per_step']} int8 products per step")
        if problems:
            raise RuntimeError(f"train step ({label}): " + "; ".join(problems))
        result["backward_norms_min"] = dict(zip(("do", "dq", "dk", "dv"), norms.min(dim=0).values.tolist()))
        phase(f"8 train step ({label})", **result, launches_run=counts[label])


def gradient_parity(name: str, quant: str = "none", depth=(PARITY_DOUBLE, PARITY_SINGLE)) -> None:
    """Phases 9, 11 and 13: a step's LoRA gradients, kernel path against
    mha_reference path, on a bf16 base or a quantized one (int8 products),
    at ``depth`` (double, single) blocks."""
    import dataclasses

    import torch

    from simpletuner_tpu_torch.bench import flagship_batch, flagship_config, perturb_adaln
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.flux import Flux, FluxConfig
    from simpletuner_tpu_torch.models.layers import freeze_base, init_parameters, quantize_module
    from simpletuner_tpu_torch.ops import set_attention_backend

    dev = torch.device("cuda")
    start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    arch = dataclasses.replace(FluxConfig(), depth_double=depth[0], depth_single=depth[1])
    model = Flux(config_namespace(flagship_config("full", quant, "full")), arch=arch)
    gen = torch.Generator(device=dev).manual_seed(9)
    with torch.device(dev):
        module = init_parameters(model.create_module(), gen)
    perturb_adaln(module, gen)
    params = freeze_base(module)
    with torch.no_grad():
        for path, param in params.items():
            if path.endswith("lora_B"):
                param.normal_(0.0, 0.01, generator=gen)
    if model.base_precision:
        quantize_module(module, model.base_precision)
    batch = flagship_batch(arch, gen)
    batch["override_noise"] = torch.randn(batch["latents"].shape, generator=gen, device=dev)
    batch["override_sigmas"] = torch.full((1,), 0.6, device=dev)

    def grads(batch):
        loss, _ = model.loss_fn(module, gen, batch)
        return loss.detach(), torch.cat([g.flatten() for g in torch.autograd.grad(loss, list(params.values()))])

    loss_kernel, kernel = grads(batch)
    _, unmasked = grads({k: v for k, v in batch.items() if k != "t5_masks"})
    set_attention_backend("xla")
    try:
        loss_plain, plain = grads(batch)
    finally:
        set_attention_backend("auto")
    peak = torch.cuda.max_memory_allocated() / 2**30
    err, mask_effect = rel_l2(kernel, plain), rel_l2(unmasked, plain)
    if not (torch.isfinite(kernel).all() and plain.norm() > 0 and err <= TRAIN_GRAD_REL_L2
            and mask_effect > 5 * err):
        raise RuntimeError(f"{name}: rel L2 {err} (<= {TRAIN_GRAD_REL_L2}), mask effect {mask_effect}")
    phase(name, blocks=list(depth), base=model.base_precision or "bf16",
          quantized_matmul=model.quantized_matmul, lora_tensors=len(params),
          loss_kernel=float(loss_kernel), loss_plain=float(loss_plain), rel_l2=err, bound=TRAIN_GRAD_REL_L2,
          unmasked_rel_l2=mask_effect, peak_gib=peak, seconds=time.perf_counter() - start)
    del module, params
    torch.cuda.empty_cache()


def graph_step(kernels):
    """Phase 12: the int8 flagship step captured as one CUDA graph against
    the eager step (bitwise), then both timed; returns each kernel's launches
    in the profiled replay, as the profiler recorded them on the card."""
    import torch

    from simpletuner_tpu_torch.bench import build_run, flagship_config, replay_launches, time_steps
    from simpletuner_tpu_torch.models.flux import FluxConfig
    from simpletuner_tpu_torch.training.quantization import int8_matmul
    from simpletuner_tpu_torch.training.train_state import jit_train_step, state_tensors

    run = build_run(flagship_config("attn", "int8", "full"), FluxConfig())
    state, batch, gen = run.state, run.batch, run.generator
    with torch.no_grad():
        saved = [t.clone() for t in state_tensors(state)]
    rng = gen.get_state()

    def restore():
        with torch.no_grad():
            for tensor, value in zip(state_tensors(state), saved):
                tensor.copy_(value)
        gen.set_state(rng)

    def trajectory(step):
        current, losses, norms = state, [], []
        for _ in range(GRAPH_CHECK_STEPS):
            current, metrics = step(current, batch, gen)
            losses.append(metrics["loss"])
            norms.append(metrics["grad_norm"])
        lora = torch.cat([p.detach().flatten() for p in current.trainable.values()])
        return torch.stack(losses), torch.stack(norms), lora.clone()

    def max_diff(a, b):
        return [float((x.float() - y.float()).abs().max()) for x, y in zip(a, b)]

    first = trajectory(run.step_fn)
    restore()
    second = trajectory(run.step_fn)
    restore()
    eager_diff = max_diff(first, second)  # losses, grad norms, LoRA tensors
    eager = time_steps(run.step_fn, state, batch, gen, GRAPH_EAGER_TIMED_STEPS, 0)
    eager.pop("state")
    restore()

    counters = (*kernels, int8_matmul)
    for counter in counters:
        counter.launches = 0
    start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    graphed = jit_train_step(run.step_fn, state, batch, gen)
    torch.cuda.synchronize()
    capture_s, capture_peak = time.perf_counter() - start, torch.cuda.max_memory_allocated() / 2**30
    captured = {counter.name: count for counter, count in graphed.captured_launches.items()}
    replayed = trajectory(graphed)
    graph_diff = max_diff(replayed, first)
    timed = time_steps(graphed, state, batch, gen, GRAPH_TIMED_STEPS, 0)
    timed.pop("state")
    # the wrappers count where they launch: the warm-up steps and the capture
    wrapper_counts = {counter.name: counter.launches for counter in counters}
    # the replay's launches as the trace records them, the replay profiled
    # again where the record falls short (bench.replay_launches)
    checked = replay_launches(lambda: graphed(state, batch, gen), captured,
                              {**{kernel.name: kernel.name for kernel in kernels}, "int_mm": "int8_gemm"})
    device = checked["launch_attempts"][-1]
    checked["idle_share_vs_median"] = 1 - checked["device_ms"] / 1e3 / timed["s_per_step_median"]
    problems = []
    if any(d > e for d, e in zip(graph_diff, eager_diff)):
        problems.append(f"graph replays differ from the eager steps by {graph_diff} (two eager runs: {eager_diff})")
    if captured != {"flash_fwd": 19 + 38 + 19, "flash_bwd_dq": 57, "flash_bwd_dkv": 57, "int_mm": 1069}:
        problems.append(f"the capture recorded {captured}")
    if device != captured:
        problems.append(f"the profiled replay launched {device} on the card, the capture recorded {captured}")
    if not all(wrapper_counts.values()):
        problems.append(f"a wrapper counted no launch on the main path: {wrapper_counts}")
    if not torch.isfinite(replayed[0]).all():
        problems.append(f"non-finite losses {replayed[0].tolist()}")
    if problems:
        raise RuntimeError("graphed train step: " + "; ".join(problems))
    summary = lambda r: {k: r[k] for k in ("s_per_step_median", "s_per_step", "step_s", "peak_gib")}  # noqa: E731
    phase("12 graphed train step", quant=run.model.base_precision, quantized_matmul=run.model.quantized_matmul,
          remat_policy="attn", check_steps=GRAPH_CHECK_STEPS, losses=replayed[0].tolist(),
          grad_norms=replayed[1].tolist(), bitwise_equal_to_eager=graph_diff == [0.0, 0.0, 0.0],
          eager_runs_bitwise_equal=eager_diff == [0.0, 0.0, 0.0], graph_vs_eager_max_diff=graph_diff,
          eager_vs_eager_max_diff=eager_diff, capture_s=capture_s, capture_peak_gib=capture_peak,
          launches_captured=captured, launches_profiled_replay=device, launch_attempts=checked["launch_attempts"],
          wrapper_counts_warmup_and_capture=wrapper_counts,
          eager={**summary(eager), "profile": "phase 8 (int8 attn) profiles the eager step"},
          graph={**summary(timed), "profile": {k: v for k, v in checked.items() if k != "launch_attempts"}},
          speedup_median=eager["s_per_step_median"] / timed["s_per_step_median"])
    del graphed, run, state, saved
    torch.cuda.empty_cache()
    return device, timed["s_per_step_median"]


def trainer_phase(paths: dict, flagship_median_s: float, kernels, device: str) -> dict:
    """Phase 17: ``Trainer.run()`` on full-width Flux at ``train_blocks()``
    with an int8 base, twice: a straight run of 8 steps, then a run resumed
    from its checkpoint-4 (the checkpoint hard-linked into a fresh output
    dir, the config otherwise the same); returns each kernel's launches in
    the two runs."""
    import numpy as np
    import torch

    from simpletuner_tpu_torch.configuration import TrainingConfig
    from simpletuner_tpu_torch.models.weight_import import load_safetensors_file
    from simpletuner_tpu_torch.training.checkpoints import flatten_state
    from simpletuner_tpu_torch.training.lora import load_lora_safetensors
    from simpletuner_tpu_torch.training.trainer import Trainer

    import gc

    gc.collect()  # the earlier phases' modules, caught in autograd reference cycles
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    start = time.perf_counter()
    work = paths["work"]
    free = shutil.disk_usage(work).free
    if free < TRAIN_CHECKPOINT_GB * 1e9:
        raise RuntimeError(f"trainer: {free / 1e9:.1f} GB free under {work}, the checkpoints need "
                           f"{TRAIN_CHECKPOINT_GB:.1f} GB")
    # 4 square and 4 landscape JPEGs of phase 16, with captions
    data = os.path.join(work, "train_data")
    os.makedirs(data)
    source = os.path.join(work, "vae_cache", "data")
    # phase 16 writes img_<i>.jpg at its sizes in turn: i % 3 == 0 square, 1 the 1152x896 bucket
    names = [f"img_{i:04d}.jpg" for i in range(0, 12, 3)] + [f"img_{i:04d}.jpg" for i in range(1, 12, 3)]
    for name, caption in zip(names, TRAIN_CAPTIONS):
        shutil.copy(os.path.join(source, name), os.path.join(data, name))
        with open(os.path.join(data, os.path.splitext(name)[0] + ".txt"), "w") as handle:
            handle.write(caption)

    def values(out, **extra):
        return {
            "model_family": "flux", "model_flavour": "dev", "model_type": "lora", "lora_rank": 16,
            "flux_lora_target": "all", "pretrained_model_name_or_path": paths["flux_dir"],
            "pretrained_transformer_model_name_or_path": paths["flux_file"],
            "base_model_precision": "int8-quanto", "quantized_matmul": "full", "gradient_checkpointing": True,
            "gradient_checkpointing_policy": "attn", "optimizer": "adamw", "learning_rate": 1e-4,
            "lr_scheduler": "constant", "flux_attention_masked_training": True, "mixed_precision": "bf16",
            "text_encoder_precision": "bf16", "vae_dtype": "bf16", "train_batch_size": 1, "resolution": 1024,
            "resolution_type": "pixel_area", "max_train_steps": TRAIN_STEPS,
            "checkpointing_steps": TRAIN_CHECKPOINT_STEPS, "logging_steps": 1, "report_to": "jsonl", "seed": 42,
            "validation_prompt": TRAIN_PROMPT, "validation_steps": TRAIN_STEPS, "validation_resolution": RESOLUTION,
            "validation_num_inference_steps": TRAIN_VALIDATION_STEPS, "validation_seed": 42,
            "validation_guidance_real": 3.5, "cache_dir": os.path.join(work, "train_cache"),
            "output_dir": os.path.join(work, out), "checkpoint_frozen_base": "reference",
            "model_arch_overrides": dict(zip(("depth_double", "depth_single"), train_blocks())),
            "data_backend_config": [
                {"id": "train", "dataset_type": "image", "type": "local", "instance_data_dir": data,
                 "resolution": 1024, "resolution_type": "pixel_area", "caption_strategy": "textfile",
                 "cache_dir_vae": os.path.join(work, "train_cache", "vae")},
                {"id": "embeds", "dataset_type": "text_embeds", "type": "local", "default": True,
                 "cache_dir": os.path.join(work, "train_cache", "text")},
            ],
            **extra,
        }

    def run(config):
        for kernel in kernels:
            kernel.launches = 0
        trainer = Trainer(config=TrainingConfig(config), device="cuda")
        t0 = time.perf_counter()
        trainer.run()
        torch.cuda.synchronize()
        launches = {kernel.name: kernel.launches for kernel in kernels}
        if not all(launches.values()):
            raise RuntimeError(f"trainer: a kernel of the path was never launched: {launches}")
        with open(os.path.join(config["output_dir"], "simpletuner-tpu-metrics.jsonl")) as handle:
            metrics = [json.loads(line) for line in handle]
        return trainer, metrics, launches, time.perf_counter() - t0

    def step_seconds(trainer, metrics):
        """Wall seconds of each logged step: log to log, without the steps
        that captured a graph or follow a checkpoint or validation."""
        skip = {c["step"] for c in trainer.capture_report}
        skip |= {int(os.path.basename(s["path"]).rsplit("-", 1)[1]) + 1 for s in trainer.checkpoint_manager.saves}
        return {m["step"]: m["time"] - prev["time"] for prev, m in zip(metrics, metrics[1:]) if m["step"] not in skip}

    def report(trainer, run_s, metrics):
        stages = trainer.stage_report
        order = list(stages)
        after = order[order.index("init_unload_text_encoder") + 1:]
        startup = trainer.data_plane.startup_metrics
        seconds = step_seconds(trainer, metrics)
        return {
            "run_s": run_s, "stage_s": {k: v["seconds"] for k, v in stages.items()},
            "stage_peak_gib": {k: v["peak_gib"] for k, v in stages.items()},
            "peak_gib_after_unload": max(stages[k]["peak_gib"] for k in after),
            "peak_gib_run": max(v["peak_gib"] for v in stages.values()),
            "allocated_gib_after_unload": stages["init_unload_text_encoder"]["allocated_gib"],
            "caching": {"images": startup.get("images_train"), "vae_s": startup.get("vae_cache_train_s"),
                        "images_per_s": startup.get("images_train", 0) / max(startup.get("vae_cache_train_s", 0), 1e-9),
                        "captions": startup.get("captions"), "text_s": startup.get("text_cache_train_s"),
                        "prompts_per_s": startup.get("captions", 0) / max(startup.get("text_cache_train_s", 0), 1e-9)},
            "capture_s": [{"step": c["step"], "seconds": c["seconds"], "latents": c["shapes"]["latents"]}
                          for c in trainer.capture_report],
            "step_s": seconds, "s_per_step_median": float(np.median(list(seconds.values()))) if seconds else None,
            "checkpoint_saves": [{"checkpoint": os.path.basename(s["path"]), "s": s["seconds"], "bytes": s["bytes"],
                                  "gb_per_s": s["bytes"] / s["seconds"] / 1e9}
                                 for s in trainer.checkpoint_manager.saves],
            "restores_s": [r["seconds"] for r in trainer.checkpoint_manager.restores],
            "full_state_bytes": sum(t.numel() * t.element_size() for t in flatten_state(trainer._state)[0].values()),
            "validation_s": [{"step": v["step"], "s": v["seconds"]} for v in trainer.validation_report],
        }

    straight, straight_metrics, straight_launches, straight_s = run(values("train_straight"))
    losses = [m["loss"] for m in straight_metrics]
    if [m["step"] for m in straight_metrics] != list(range(1, TRAIN_STEPS + 1)) or \
            not all(np.isfinite(losses)) or not all(m["grad_norm"] > 0 for m in straight_metrics):
        raise RuntimeError(f"trainer: metrics {straight_metrics}")
    if len(straight.capture_report) != 2:
        raise RuntimeError(f"trainer: {len(straight.capture_report)} graphs captured, expected one per bucket")
    out = os.path.join(work, "train_straight")
    for step in (TRAIN_CHECKPOINT_STEPS, TRAIN_STEPS):
        checkpoint = os.path.join(out, f"checkpoint-{step}")
        present = set(os.listdir(checkpoint))
        needed = {".checkpoint_complete", "manifest.json", "trainer_state.json", "pytorch_lora_weights.safetensors"}
        if not needed <= present:
            raise RuntimeError(f"trainer: {checkpoint} holds {sorted(present)}")
        missing = load_lora_safetensors(straight.model, os.path.join(checkpoint, "pytorch_lora_weights.safetensors"),
                                        straight._state.module)
        if missing:
            raise RuntimeError(f"trainer: the export of {checkpoint} lacks {missing[:4]}")
    png = os.path.join(out, "validation", f"step_{TRAIN_STEPS}_0.png")
    check_png(png, RESOLUTION, RESOLUTION)
    straight_report = report(straight, straight_s, straight_metrics)
    del straight
    torch.cuda.empty_cache()

    # the resumed run: checkpoint-4 in a fresh output dir, its files hard-linked
    resumed_out = os.path.join(work, "train_resumed")
    shutil.copytree(os.path.join(out, f"checkpoint-{TRAIN_CHECKPOINT_STEPS}"),
                    os.path.join(resumed_out, f"checkpoint-{TRAIN_CHECKPOINT_STEPS}"), copy_function=os.link)
    final_lora = load_safetensors_file(os.path.join(out, f"checkpoint-{TRAIN_STEPS}",
                                                    "pytorch_lora_weights.safetensors"))
    shutil.rmtree(os.path.join(out, f"checkpoint-{TRAIN_STEPS}", "state"))  # disk for the resumed run's
    resumed, resumed_metrics, resumed_launches, resumed_s = run(values(
        "train_resumed", resume_from_checkpoint="latest", profile_steps="6-8"))
    tail = straight_metrics[TRAIN_CHECKPOINT_STEPS:]
    if [m["step"] for m in resumed_metrics] != [m["step"] for m in tail] or \
            [m["loss"] for m in resumed_metrics] != [m["loss"] for m in tail]:
        raise RuntimeError(f"trainer: the resumed run's losses {[m['loss'] for m in resumed_metrics]} are not the "
                           f"straight run's {[m['loss'] for m in tail]}")
    resumed_lora = load_safetensors_file(os.path.join(resumed_out, f"checkpoint-{TRAIN_STEPS}",
                                                      "pytorch_lora_weights.safetensors"))
    if sorted(resumed_lora) != sorted(final_lora) or not all(torch.equal(resumed_lora[k], final_lora[k])
                                                           for k in final_lora):
        raise RuntimeError("trainer: the resumed run's final LoRA differs from the straight run's")
    resumed_report = report(resumed, resumed_s, resumed_metrics)
    blocks = list(train_blocks())
    full_depth = blocks == [19, 38]  # phase 12's graphed flagship is the full depth
    phase("17 trainer", blocks=blocks, depth={"blocks": blocks, "of": [19, 38]}, hidden=3072, base="int8", quantized_matmul="full", remat_policy="attn",
          lora_rank=16, buckets=["1024x1024", "1152x896"], steps=TRAIN_STEPS, losses=losses,
          grad_norms=[m["grad_norm"] for m in straight_metrics], resumed_losses_bitwise=True,
          resumed_final_lora_bitwise=True, lora_tensors=len(final_lora), validation_png=os.path.basename(png),
          launches_straight=straight_launches, launches_resumed=resumed_launches,
          straight=straight_report, resumed=resumed_report,
          profiled_window=resumed.profiler.summary, flagship_graphed_median_s=flagship_median_s,
          allocated_gib_before_phase=baseline_gib,
          trainer_vs_flagship=(straight_report["s_per_step_median"] / flagship_median_s
                               if full_depth and straight_report["s_per_step_median"] and flagship_median_s
                               else None),
          seconds=time.perf_counter() - start, device=device)
    del resumed
    torch.cuda.empty_cache()
    return {"straight": straight_launches, "resumed": resumed_launches, "config": values("train_straight"),
            "losses": losses, "grad_norms": [m["grad_norm"] for m in straight_metrics], "final_lora": final_lora,
            "png": png, "checkpoint": os.path.join(resumed_out, f"checkpoint-{TRAIN_STEPS}"), "data": data}


def server_phase(phase17: dict, device: str) -> None:
    """Phase 18: the port's training server in this process on an ephemeral
    port (``device="cuda"``): health, the hardware report, config validation;
    a training job (phase 17's straight run with an eval split added: two of
    phase 16's JPEGs that phase 17 does not train on, ``eval_steps_interval``
    4) in a child process, whose losses and final LoRA must equal phase 17's
    bitwise and which logs a finite eval loss at steps 4 and 8; and at the
    same time (the server runs two jobs at once; one after the other before
    phases 39-41) a render job, ``cli inference`` from phase 17's
    checkpoint-8 in a second child process, whose PNG must equal phase 17's
    final validation image byte for byte.
    The events stream (``/api/events``) must show both jobs start and
    finish."""
    import ast
    import http.client
    import re
    import threading

    import torch

    from simpletuner_tpu_torch.models.weight_import import load_safetensors_file
    from simpletuner_tpu_torch.server.app import create_server

    import gc

    gc.collect()
    torch.cuda.empty_cache()
    parent_gib = {"allocated": torch.cuda.memory_allocated() / 2**30, "reserved": torch.cuda.memory_reserved() / 2**30}
    start = time.perf_counter()
    work = os.path.dirname(phase17["data"])
    held = os.path.join(work, "held_out")
    os.makedirs(held)
    source = os.path.join(work, "vae_cache", "data")
    for i, index in enumerate(SERVER_EVAL_IMAGES):  # square JPEGs that phase 17 does not train on
        name = f"img_{index:04d}.jpg"
        shutil.copy(os.path.join(source, name), os.path.join(held, name))
        with open(os.path.join(held, os.path.splitext(name)[0] + ".txt"), "w") as handle:
            handle.write(f"a held-out seeded photo number {i}")
    config = json.loads(json.dumps(phase17["config"]))
    config["output_dir"] = os.path.join(work, "server_train")
    config["eval_steps_interval"] = TRAIN_CHECKPOINT_STEPS
    config["eval_timesteps"] = SERVER_EVAL_DRAWS
    config["data_backend_config"].insert(1, {
        "id": "held_out", "dataset_type": "eval", "type": "local", "instance_data_dir": held,
        "resolution": config["resolution"],
        "resolution_type": "pixel_area", "caption_strategy": "textfile",
        "cache_dir_vae": os.path.join(work, "train_cache", "vae_held_out")})
    render_config = os.path.join(work, "phase17_config.json")
    with open(render_config, "w") as handle:
        json.dump(phase17["config"], handle)
    blocks = list(train_blocks())  # the children read it from phase 17's model_arch_overrides

    # two job slots: the training job and the render job (which renders from
    # phase 17's checkpoint, not the job's) run at once, one child each
    srv = create_server("127.0.0.1", 0, state_dir=os.path.join(work, "server_state"), device="cuda",
                        max_concurrent_jobs=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]

    def api(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        payload = json.dumps(body) if body is not None else None
        conn.request(method, path, body=payload, headers={"Content-Type": "application/json"} if payload else {})
        response = conn.getresponse()
        data = json.loads(response.read() or b"null")
        conn.close()
        return response.status, data

    events, listener = [], http.client.HTTPConnection("127.0.0.1", port, timeout=None)

    def listen():
        listener.request("GET", "/api/events")
        response = listener.getresponse()
        try:
            for line in response:
                if line.startswith(b"data: "):
                    events.append(json.loads(line[6:]))
        except (OSError, ValueError):
            pass

    threading.Thread(target=listen, daemon=True).start()

    def submit(path, body):
        status, job = api("POST", path, body)
        if status != 201:
            raise RuntimeError(f"server: {path} answered {status} {job}")
        return path, job

    def wait(submitted, timeout):
        path, job = submitted
        deadline = time.time() + timeout
        while time.time() < deadline:
            _, info = api("GET", f"/api/training/status/{job['job_id']}")
            if info["state"] in ("completed", "failed", "cancelled"):
                break
            time.sleep(1.0)
        _, logs = api("GET", f"/api/training/logs/{job['job_id']}?tail=2000")
        if info["state"] != "completed" or info["return_code"] != 0:
            tail = "\n".join(logs["logs"][-40:])
            raise RuntimeError(f"server: job {job['job_id']} ({path}) ended {info['state']} rc "
                               f"{info['return_code']}:\n{tail}")
        return info, logs["logs"]

    try:
        status, health = api("GET", "/health")
        _, hardware = api("GET", "/api/hardware")
        kinds = [d["kind"] for d in hardware["accelerators"]]
        if status != 200 or health["status"] != "ok" or not kinds or "H100" not in kinds[0]:
            raise RuntimeError(f"server: health {status} {health}, accelerators {kinds}")
        status, valid = api("POST", "/api/config/validate", {"config": config})
        if status != 200 or not valid.get("valid"):
            raise RuntimeError(f"server: config validation answered {status} {valid}")

        render_out = os.path.join(work, "server_render")
        train_job = submit("/api/training/start", {"config": config})
        render_job = submit("/api/inference/start", {
            "checkpoint": phase17["checkpoint"], "prompt": TRAIN_PROMPT, "steps": TRAIN_VALIDATION_STEPS,
            "seed": 42, "resolution": RESOLUTION, "config": render_config, "output": render_out})
        train_info, train_logs = wait(train_job, timeout=900)
        render_info, render_logs = wait(render_job, timeout=600)
        with open(os.path.join(config["output_dir"], "simpletuner-tpu-metrics.jsonl")) as handle:
            metrics = [json.loads(line) for line in handle]
        steps = [m for m in metrics if "loss" in m]
        evals = [m for m in metrics if "eval_loss" in m]
        if [m["loss"] for m in steps] != phase17["losses"] or [m["grad_norm"] for m in steps] != phase17["grad_norms"]:
            raise RuntimeError(f"server: the job's losses {[m['loss'] for m in steps]} are not phase 17's "
                               f"{phase17['losses']}")
        if [m["step"] for m in evals] != [TRAIN_CHECKPOINT_STEPS, TRAIN_STEPS] or \
                not all(math.isfinite(m["eval_loss"]) for m in evals):
            raise RuntimeError(f"server: eval lines {evals}")
        lora = load_safetensors_file(os.path.join(config["output_dir"], f"checkpoint-{TRAIN_STEPS}",
                                                  "pytorch_lora_weights.safetensors"))
        final = phase17["final_lora"]
        if sorted(lora) != sorted(final) or not all(torch.equal(lora[k], final[k]) for k in final):
            raise RuntimeError("server: the job's final LoRA differs from phase 17's")
        stages = {m.group(1): ast.literal_eval(m.group(2)) for m in
                  (re.search(r"stage (\w+): (\{.*\})", line) for line in train_logs) if m}
        eval_s = [float(m.group(1)) for m in (re.search(r"eval_loss \S+ at step \d+ \(([\d.]+) s\)", line)
                                              for line in train_logs) if m]

        png = os.path.join(render_out, "validation", f"step_{TRAIN_STEPS}_0.png")
        check_png(png, RESOLUTION, RESOLUTION)
        with open(png, "rb") as a, open(phase17["png"], "rb") as b:
            if a.read() != b.read():
                raise RuntimeError(f"server: the render {png} differs from phase 17's {phase17['png']}")
        render_peak = [float(m.group(1)) for m in (re.search(r"peak device memory: ([\d.]+) GiB", line)
                                                   for line in render_logs) if m]
        seen = {(e.get("event_type"), e.get("job_id")) for e in events}
        for info in (train_info, render_info):
            for kind in ("job_started", "job_finished"):
                if (kind, info["job_id"]) not in seen:
                    raise RuntimeError(f"server: the events stream lacks {kind} of {info['job_id']}: {sorted(seen)}")
    finally:
        for job in list(srv.keeper.jobs.values()):
            if job.process is not None and job.process.poll() is None:
                job.process.kill()
                job.process.wait()
        listener.close()
        srv.run_queue.close()
        srv.shutdown()
        srv.server_close()

    phase("18 server", blocks=blocks, depth={"blocks": blocks, "of": [19, 38]}, hidden=3072, base="int8", steps=TRAIN_STEPS, losses_bitwise=True,
          final_lora_bitwise=True, render_png_bitwise=True, render_png=os.path.basename(png),
          eval_loss={m["step"]: m["eval_loss"] for m in evals}, eval_s=eval_s, eval_images=len(SERVER_EVAL_IMAGES),
          eval_draws_per_image=SERVER_EVAL_DRAWS,
          train_job_s=train_info["finished_at"] - train_info["started_at"],
          time_to_first_step_s=steps[0]["time"] - train_info["started_at"],
          train_child_peak_gib=max((v.get("peak_gib", 0.0) for v in stages.values()), default=None),
          train_child_stage_peak_gib={k: v.get("peak_gib") for k, v in stages.items()},
          render_job_s=render_info["finished_at"] - render_info["started_at"], jobs_at_once=2,
          jobs_overlap_s=min(train_info["finished_at"], render_info["finished_at"])
          - max(train_info["started_at"], render_info["started_at"]),
          render_child_peak_gib=render_peak[-1] if render_peak else None,
          parent_gib_before_phase=parent_gib, hardware=kinds, seconds=time.perf_counter() - start, device=device)


def sd3_step_flops(arch, batch: int, s_img: int, s_txt: int) -> float:
    """Model matmul FLOPs of one SD3 train step in bench.py's convention
    (forward x 3; remat recompute is hardware work, not model work): per
    block the image stream's q, k, v, proj and MLP, the text stream's (the
    last block, context_pre_only, has only q, k, v), joint attention at 4 x S
    x hidden per token; the patch, context and output projections."""
    h, mlp = arch.hidden_size, arch.mlp_ratio
    stream = 2 * h * h * (4 + 2 * mlp)
    s = s_img + s_txt
    fwd = s_img * arch.depth * stream + s_txt * ((arch.depth - 1) * stream + 2 * h * h * 3)
    fwd += s * arch.depth * 4 * s * h
    p2c = arch.patch_size ** 2 * arch.in_channels
    fwd += s_img * 2 * p2c * h * 2 + s_txt * 2 * arch.context_dim * h
    return batch * fwd * 3.0


def _link_tree(source: str, target: str) -> None:
    """``source``'s files hard-linked under ``target`` (nothing is written)."""
    shutil.copytree(source, target, copy_function=os.link)


def sd3_phase(paths: dict, kernels, device: str, depth: int) -> None:
    """Phase 19: SD3.5 Large at full width, ``depth`` of its 38 blocks: a seeded diffusers
    transformer file, CLIP-G and a 16-channel VAE written with the port's
    writer beside hard links to phase 14-15's CLIP-L, T5-XXL and tokenizers;
    the import held bitwise to the written tensors; a 1024 px render with
    true CFG through ``CheckpointInferenceRuntime``; one denoise call with
    the kernels against the plain attention; ``Trainer.run()`` with an int8
    base; the kernels' launches of a profiled replay against the capture's."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from simpletuner_tpu_torch.bench import replay_launches
    from simpletuner_tpu_torch.inference import CheckpointInferenceRuntime, config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import (
        clip_checkpoint_shapes, sd3_checkpoint_shapes, vae_checkpoint_shapes,
    )
    from simpletuner_tpu_torch.models.clip import CLIPTextConfig
    from simpletuner_tpu_torch.models.sd3 import SD3, SD3Config
    from simpletuner_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from simpletuner_tpu_torch.models.weight_bridge import flax_to_state_dict
    from simpletuner_tpu_torch.models.weight_import import (
        load_transformer_params, save_safetensors, sd3_params_from_diffusers,
    )
    from simpletuner_tpu_torch.ops import set_attention_backend
    from simpletuner_tpu_torch.training.quantization import int8_matmul
    from simpletuner_tpu_torch.training.trainer import Trainer

    start = time.perf_counter()
    work, flux_dir = paths["work"], paths["flux_dir"]
    # phase 14's Flux file and phase 17-18's outputs: disk space (not the write budget)
    os.remove(paths["flux_file"])
    for out in ("train_straight", "train_resumed", "server_train"):
        shutil.rmtree(os.path.join(work, out), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    arch = dataclasses.replace(SD3Config.large(), depth=depth)
    shapes = sd3_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    free, written_before = shutil.disk_usage(work).free, _written_gb()
    if free < file_bytes + 4e9 or written_before + file_bytes / 1e9 + 0.55 + _reserved(19) > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"sd3: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the phase; "
                           f"the files need {file_bytes / 1e9:.1f} GB and the later phases {_reserved(19):.1f} GB of "
                           f"the {RUN_WRITE_TARGET_GB} GB a run may write")

    # (b) the seeded files: transformer (two shards, e4m3 as phase 14's Flux
    # file: the write budget), CLIP-G with its projection, the VAE with both
    # quant convs; hard links to the rest
    sd3_dir = os.path.join(work, "sd3")
    os.makedirs(os.path.join(sd3_dir, "transformer"))
    weights = {k: v.to(torch.float8_e4m3fn) for k, v in seeded_weights(shapes, gen).items()}
    names = sorted(weights)
    t0 = time.perf_counter()
    for shard, part in enumerate((names[: len(names) // 2], names[len(names) // 2:])):
        save_safetensors({k: weights[k] for k in part}, os.path.join(
            sd3_dir, "transformer", f"diffusion_pytorch_model-0000{shard + 1}-of-00002.safetensors"))
    write_s = time.perf_counter() - t0
    clip_g = dataclasses.replace(CLIPTextConfig.clip_g(), num_hidden_layers=PHASE19_CLIP_G_LAYERS)
    os.makedirs(os.path.join(sd3_dir, "text_encoder_2"))
    save_safetensors(seeded_weights(clip_checkpoint_shapes(clip_g, projection=True), gen),
                     os.path.join(sd3_dir, "text_encoder_2", "model.safetensors"))
    with open(os.path.join(sd3_dir, "text_encoder_2", "config.json"), "w") as handle:
        json.dump({**dataclasses.asdict(clip_g), "projection_dim": clip_g.hidden_size,
                   "architectures": ["CLIPTextModelWithProjection"]}, handle)
    with torch.device(dev):
        vae = AutoencoderKL(VAEConfig.flux(), torch.bfloat16)
    os.makedirs(os.path.join(sd3_dir, "vae"))
    save_safetensors(seeded_weights(vae_checkpoint_shapes(vae), gen),
                     os.path.join(sd3_dir, "vae", "diffusion_pytorch_model.safetensors"))
    del vae
    for source, target in (("text_encoder", "text_encoder"), ("text_encoder_2", "text_encoder_3"),
                           ("tokenizer", "tokenizer"), ("tokenizer_2", "tokenizer_2")):
        _link_tree(os.path.join(flux_dir, source), os.path.join(sd3_dir, target))
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9,
             "clip_g_params": sum(math.prod(v) for v in clip_checkpoint_shapes(clip_g).values()),
             "clip_g_layers": [PHASE19_CLIP_G_LAYERS, CLIPTextConfig.clip_g().num_hidden_layers],
             "written_gb_before": written_before, "written_gb_after": _written_gb(), "free_gb_before": free / 1e9}

    # (c) import through load_transformer_params, every tensor bitwise the
    # written one taken to bf16 (exact for every e4m3 value)
    model = SD3(config_namespace({"model_family": "sd3", "model_flavour": "large-3.5", "model_type": "full"}))
    if model.arch != arch:
        raise RuntimeError(f"sd3: large-3.5 builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()  # model_type full: no adapters
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rss_before = _rss_gib()
    t0 = time.perf_counter()
    load_transformer_params(model, module, sd3_dir)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    imported = {"s": load_s, "gb_per_s": file_bytes / load_s / 1e9, "host_rss_gib": {"before": rss_before,
                "after": _rss_gib()}, "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
                "params": sum(p.numel() for p in module.parameters())}
    expected = flax_to_state_dict(sd3_params_from_diffusers(weights, arch), module)
    unequal = [k for k, v in module.state_dict().items() if not torch.equal(v, expected[k])]
    if unequal:
        raise RuntimeError(f"sd3: the imported module differs from the written tensors at {unequal[:8]}")
    imported["tensors_bitwise"] = len(expected)
    del weights, expected, module
    gc.collect()
    torch.cuda.empty_cache()

    # (d) a 1024x1024 render with true CFG through the checkpoint runtime
    config_path = os.path.join(work, "sd3_render.json")
    with open(config_path, "w") as handle:
        json.dump({"model_family": "sd3", "model_flavour": "large-3.5", "model_type": "full",
                   "pretrained_model_name_or_path": sd3_dir, "mixed_precision": "bf16",
                   "text_encoder_precision": "bf16", "vae_dtype": "bf16", "validation_resolution": RESOLUTION,
                   "validation_seed": 42, "seed": 42, "validation_guidance": SD3_GUIDANCE}, handle)
    t0 = time.perf_counter()
    runtime = CheckpointInferenceRuntime(config_path=config_path, output=os.path.join(work, "sd3_render"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    module, model = runtime.module, runtime.model
    if model.arch != arch or model.NAME != "sd3":
        raise RuntimeError(f"sd3: the runtime built {model.NAME} {model.arch}, not SD3.5 Large")
    forward_s, finite = [], []

    def before(mod, args):
        torch.cuda.synchronize()
        forward_s.append(-time.perf_counter())

    def after(mod, args, out):
        torch.cuda.synchronize()
        forward_s[-1] += time.perf_counter()

    decode = runtime.vae.decode

    def decode_checked(z):
        finite.append(bool(torch.isfinite(z).all()))
        return decode(z)

    hooks = [module.register_forward_pre_hook(before), module.register_forward_hook(after)]
    runtime.vae.decode = decode_checked
    for kernel in kernels:
        kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pngs = runtime.render(SD3_PROMPT, steps=STEPS, guidance=SD3_GUIDANCE)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    render_launches = {kernel.name: kernel.launches for kernel in kernels}
    render_peak = torch.cuda.max_memory_allocated() / 2**30
    runtime.vae.decode = decode
    for hook in hooks:
        hook.remove()
    if render_launches != {"flash_fwd": arch.depth * 2 * STEPS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}:
        raise RuntimeError(f"sd3 render: launches {render_launches}, expected {arch.depth} per forward, two "
                           f"forwards per step")
    if len(pngs) != 1 or finite != [True] or len(forward_s) != 2 * STEPS:
        raise RuntimeError(f"sd3 render: {pngs}, finite latents {finite}, {len(forward_s)} forwards")
    check_png(pngs[0], RESOLUTION, RESOLUTION)

    # (e) one full-depth denoise call, kernels against the plain attention
    latent = RESOLUTION // 8
    batch = {"latents": torch.zeros((1, latent, latent, 16), device=dev)}
    for key, value in model.collate_text_embeds(model.encode_text([SD3_PROMPT])).items():
        batch[key] = torch.as_tensor(value, device=dev)
    if tuple(batch["text_embeds"].shape) != (1, SD3_TXT, 4096):
        raise RuntimeError(f"sd3: text_embeds {tuple(batch['text_embeds'].shape)}, expected (1, {SD3_TXT}, 4096)")
    model.text_encoders = []  # the plain attention's scores need the room
    gc.collect()
    torch.cuda.empty_cache()
    cond = model.inference_conditioning(batch)
    noise = torch.randn((1, latent, latent, 16), generator=gen, device=dev)
    with torch.no_grad():
        kernel_v = model.denoise_fn(module, cond)(noise, torch.tensor(0.7))
        set_attention_backend("xla")
        try:
            plain_v = model.denoise_fn(module, cond)(noise, torch.tensor(0.7))
        finally:
            set_attention_backend("auto")
    parity = rel_l2(kernel_v, plain_v)
    if not (torch.isfinite(kernel_v).all() and torch.isfinite(plain_v).all() and parity <= PARITY_REL_L2):
        raise RuntimeError(f"sd3 full-depth parity: rel L2 {parity} (<= {PARITY_REL_L2})")
    del runtime, module, model, kernel_v, plain_v, batch, cond
    gc.collect()
    torch.cuda.empty_cache()

    # (f) Trainer.run(): int8 base, full remat, rank-16 LoRA, one square bucket, graphed
    data = os.path.join(work, "sd3_data")
    os.makedirs(data)
    source = os.path.join(work, "vae_cache", "data")
    for i, index in enumerate(range(0, 3 * SD3_TRAIN_IMAGES, 3)):  # phase 16's square JPEGs
        name = f"img_{index:04d}.jpg"
        os.link(os.path.join(source, name), os.path.join(data, name))
        with open(os.path.join(data, f"img_{index:04d}.txt"), "w") as handle:
            handle.write(TRAIN_CAPTIONS[i])
    out = os.path.join(work, "sd3_train")
    config = {
        "model_family": "sd3", "model_flavour": "large-3.5", "model_type": "lora", "lora_rank": 16,
        "pretrained_model_name_or_path": sd3_dir, "base_model_precision": "int8-quanto", "quantized_matmul": "full",
        "gradient_checkpointing": True, "optimizer": "adamw", "learning_rate": 1e-4, "lr_scheduler": "constant",
        "mixed_precision": "bf16", "text_encoder_precision": "bf16", "vae_dtype": "bf16", "train_batch_size": 1,
        "resolution": RESOLUTION, "resolution_type": "pixel_area", "max_train_steps": SD3_TRAIN_STEPS,
        "logging_steps": 1, "report_to": "jsonl", "seed": 42, "cache_dir": os.path.join(work, "sd3_cache"),
        "output_dir": out, "checkpoint_frozen_base": "reference",
        "data_backend_config": [
            {"id": "train", "dataset_type": "image", "type": "local", "instance_data_dir": data,
             "resolution": RESOLUTION, "resolution_type": "pixel_area", "caption_strategy": "textfile",
             "cache_dir_vae": os.path.join(work, "sd3_cache", "vae")},
            {"id": "embeds", "dataset_type": "text_embeds", "type": "local", "default": True,
             "cache_dir": os.path.join(work, "sd3_cache", "text")},
        ],
    }
    for kernel in kernels:
        kernel.launches = 0
    int8_matmul.launches = 0
    trainer = Trainer(config=config, device="cuda")
    run_start = time.time()
    trainer.run()
    torch.cuda.synchronize()
    run_s = time.time() - run_start
    train_launches = {kernel.name: kernel.launches for kernel in kernels}
    with open(os.path.join(out, "simpletuner-tpu-metrics.jsonl")) as handle:
        metrics = [json.loads(line) for line in handle]
    losses = [m["loss"] for m in metrics]
    if [m["step"] for m in metrics] != list(range(1, SD3_TRAIN_STEPS + 1)) or not all(np.isfinite(losses)) or \
            not all(m["grad_norm"] > 0 for m in metrics) or not all(train_launches.values()):
        raise RuntimeError(f"sd3 trainer: metrics {metrics}, launches {train_launches}")
    if len(trainer._graphs) != 1 or trainer.model.arch != arch:
        raise RuntimeError(f"sd3 trainer: {len(trainer._graphs)} graphs, arch {trainer.model.arch}")
    captures = {c["step"] for c in trainer.capture_report}
    step_s = {m["step"]: m["time"] - prev["time"] for prev, m in zip(metrics, metrics[1:]) if m["step"] not in captures}
    median_s = float(np.median(list(step_s.values())))
    graphed = next(iter(trainer._graphs.values()))
    captured = {counter.name: count for counter, count in graphed.captured_launches.items()}
    profile = replay_launches(lambda: graphed(trainer._state, graphed.batch, trainer._generator), captured,
                              {kernel.name: kernel.name for kernel in kernels})
    # the three kernels' launches as the profiler recorded them on the card; the
    # int8 products are printed beside the capture's count, not held to it: a
    # cuBLAS int8 kernel whose name carries none of the bucket's tags lands in
    # another bucket (one of 1,520 did in one run)
    recorded = profile["bucket_launches"]
    replayed = {kernel.name: recorded[kernel.name] for kernel in kernels}
    expected_launches = {"flash_fwd": 2 * arch.depth, "flash_bwd_dq": arch.depth, "flash_bwd_dkv": arch.depth}
    if replayed != {k: captured[k] for k in replayed} or replayed != expected_launches:
        raise RuntimeError(f"sd3 trainer: the profiled replay launched {replayed}, the capture recorded {captured}")
    replayed["int8_gemm_bucket"] = recorded["int8_gemm"]
    s_img, s_txt = (RESOLUTION // 16) ** 2, SD3_TXT
    flops = sd3_step_flops(arch, 1, s_img, s_txt)
    stages = trainer.stage_report
    phase("19 sd3", config="stabilityai/stable-diffusion-3.5-large transformer/config.json", hidden=arch.hidden_size,
          heads=[arch.num_heads, arch.head_dim], blocks=arch.depth, depth=[arch.depth, 38],
          pos_embed_max_size=arch.pos_embed_max_size,
          tokens={"text": s_txt, "image": s_img}, files=files, imported=imported,
          render={"init_s": init_s, "render_s": render_s, "steps": STEPS, "guidance": SD3_GUIDANCE,
                  "s_per_step": sum(forward_s[2:]) / (len(forward_s) - 2) * 2, "forward_s": forward_s,
                  "peak_gib": render_peak, "launches": render_launches, "png": os.path.basename(pngs[0]),
                  "png_bytes": os.path.getsize(pngs[0])},
          parity={"rel_l2": parity, "bound": PARITY_REL_L2},
          train={"base": "int8", "quantized_matmul": "full", "remat": "every block", "lora_rank": 16,
                 "lora_params": sum(p.numel() for p in trainer._state.trainable.values()),
                 "losses": losses, "grad_norms": [m["grad_norm"] for m in metrics], "step_s": step_s,
                 "s_per_step_median": median_s, "flops_per_step": flops,
                 "mfu": flops / median_s / PEAK_BF16_FLOPS, "run_s": run_s,
                 "time_to_first_step_s": metrics[0]["time"] - run_start,
                 "capture_s": [c["seconds"] for c in trainer.capture_report],
                 "stage_s": {k: v["seconds"] for k, v in stages.items()},
                 "peak_gib": max(v["peak_gib"] for v in stages.values()),
                 "stage_peak_gib": {k: v["peak_gib"] for k, v in stages.items()},
                 "launches_run": train_launches, "launches_captured": captured, "launches_profiled_replay": replayed,
                 "profile": {k: profile[k] for k in ("bucket_ms", "device_ms", "idle_share_traced")}},
          allocated_gib_before_phase=baseline_gib, written_gb=_written_gb(), seconds=time.perf_counter() - start,
          device=device)
    del trainer, graphed
    gc.collect()
    torch.cuda.empty_cache()


def sdxl_step_flops(arch, batch: int, height: int, width: int, txt: int) -> float:
    """Model FLOPs of one SDXL train step in bench.py's convention (forward x
    3; remat recompute is hardware work, not model work), counted from the
    UNet config at ``height`` x ``width`` latents: every convolution (conv_in,
    each resnet's two 3x3 convs and 1x1 shortcut, down- and upsampling,
    conv_out), each spatial transformer's proj_in / proj_out, per block the
    self-attention's q, k, v and out, the cross-attention's q and out over
    the image tokens and k and v over the ``txt`` text tokens, both
    attentions at 4 x S x S_k x C, the GEGLU feed-forward (C -> 8C, 4C -> C),
    and the time and added-conditioning MLPs."""
    c0, time_dim = arch.block_out_channels[0], arch.block_out_channels[0] * 4
    fwd = 2.0 * (c0 * time_dim + time_dim * time_dim)
    if arch.addition_embed_dim:
        fwd += 2.0 * (arch.addition_embed_dim * time_dim + time_dim * time_dim)

    def conv(tokens, cin, cout, kernel=3):
        return 2.0 * tokens * cin * cout * kernel * kernel

    def resnet(tokens, cin, cout):
        return conv(tokens, cin, cout) + conv(tokens, cout, cout) + (conv(tokens, cin, cout, 1) if cin != cout else 0) \
            + 2.0 * time_dim * cout

    def spatial(tokens, channels, depth):
        per_block = 2.0 * tokens * channels * channels * 6  # attn1 q k v out, attn2 q out
        per_block += 2.0 * txt * arch.cross_attention_dim * channels * 2  # attn2 k v
        per_block += 4.0 * tokens * (tokens + txt) * channels  # both attentions' two products
        per_block += 2.0 * tokens * channels * 12 * channels  # GEGLU: C -> 8C, 4C -> C
        return 2.0 * tokens * channels * channels * 2 + depth * per_block

    tokens = height * width
    fwd += conv(tokens, arch.in_channels, c0)
    skips, channels, levels = [c0], c0, len(arch.block_out_channels)
    for level, out_ch in enumerate(arch.block_out_channels):
        for _ in range(arch.layers_per_block):
            fwd += resnet(tokens, channels, out_ch)
            channels = out_ch
            if arch.cross_attention_blocks[level]:
                fwd += spatial(tokens, out_ch, arch.depth_at(level))
            skips.append(channels)
        if level < levels - 1:
            tokens //= 4
            fwd += conv(tokens, out_ch, out_ch)
            skips.append(channels)
    mid = arch.block_out_channels[-1]
    fwd += resnet(tokens, channels, mid) + spatial(tokens, mid, arch.depth_at(levels - 1)) + resnet(tokens, mid, mid)
    channels = mid
    for level in reversed(range(levels)):
        out_ch = arch.block_out_channels[level]
        for _ in range(arch.layers_per_block + 1):
            fwd += resnet(tokens, channels + skips.pop(), out_ch)
            channels = out_ch
            if arch.cross_attention_blocks[level]:
                fwd += spatial(tokens, out_ch, arch.depth_at(level))
        if level > 0:
            tokens *= 4
            fwd += conv(tokens, out_ch, out_ch)
    fwd += conv(tokens, channels, arch.out_channels)
    return batch * fwd * 3.0


def sdxl_phase(paths: dict, kernels, device: str, layers: tuple) -> None:
    """Phase 20: SDXL at full width as the JAX preset builds it, ``layers``
    the transformer depth of its three levels (``SDXL_CUT_LAYERS`` in a run of
    every phase, the preset's (1, 2, 10) in a run that names it): a
    seeded diffusers UNet and a 4-channel VAE written with the port's writer
    beside hard links to phase 14's CLIP-L and tokenizer and phase 19's CLIP-G;
    the import held bitwise to the written tensors; a 1024 px render with true
    CFG through ``CheckpointInferenceRuntime`` with DDIM, then UniPC; one UNet
    forward with the kernels against the plain attention; ``Trainer.run()``
    with a bf16 base, rank-16 LoRA on the attention projections, remat and
    min-SNR; the kernels' launches of a profiled replay against the capture's."""
    import gc

    import numpy as np
    import torch

    from simpletuner_tpu_torch.bench import replay_launches
    from simpletuner_tpu_torch.inference import CheckpointInferenceRuntime, config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import unet_checkpoint_shapes, vae_checkpoint_shapes
    from simpletuner_tpu_torch.models.sdxl import SDXL
    from simpletuner_tpu_torch.models.unet import UNetConfig
    from simpletuner_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from simpletuner_tpu_torch.models.weight_bridge import flax_to_state_dict
    from simpletuner_tpu_torch.models.weight_import import (
        load_transformer_params, save_safetensors, unet_params_from_diffusers,
    )
    from simpletuner_tpu_torch.ops import set_attention_backend
    from simpletuner_tpu_torch.schedulers import DDIMScheduler, UniPCScheduler
    from simpletuner_tpu_torch.training.trainer import Trainer
    from simpletuner_tpu_torch.training.validation import build_scheduler

    start = time.perf_counter()
    work, flux_dir, sd3_dir = paths["work"], paths["flux_dir"], os.path.join(paths["work"], "sd3")
    # phase 19's transformer and outputs: disk space (not the write budget)
    for out in (os.path.join(sd3_dir, "transformer"), os.path.join(work, "sd3_train"), os.path.join(work, "sd3_cache")):
        shutil.rmtree(out, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    arch = dataclasses.replace(UNetConfig.sdxl(), transformer_layers=layers)
    shapes = unet_checkpoint_shapes(arch)
    params = sum(math.prod(shape) for shape in shapes.values())
    # e4m3, which the importer takes to bf16 exactly; bf16 only in a run that
    # names phase 20 and leaves room for it (_full_depth's rule)
    written_before = _written_gb()
    fp8 = not _full_depth(20, params / 1e9)
    file_bytes = (1 if fp8 else 2) * params
    free = shutil.disk_usage(work).free
    if free < file_bytes + 4e9 or written_before + file_bytes / 1e9 + 0.3 + _reserved(20) > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"sdxl: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the phase; "
                           f"the UNet needs {file_bytes / 1e9:.1f} GB and the later phases {_reserved(20):.1f} GB of "
                           f"the {RUN_WRITE_TARGET_GB} GB a run may write")

    # (b) the seeded files: the UNet (two shards) and the 4-channel VAE; hard
    # links to phase 14's CLIP-L and tokenizer and phase 19's CLIP-G (both
    # SDXL specs read ``tokenizer``)
    sdxl_dir = os.path.join(work, "sdxl")
    os.makedirs(os.path.join(sdxl_dir, "unet"))
    weights = seeded_weights(shapes, gen)
    if fp8:
        weights = {k: v.to(torch.float8_e4m3fn) for k, v in weights.items()}
    names = sorted(weights)
    t0 = time.perf_counter()
    for shard, part in enumerate((names[: len(names) // 2], names[len(names) // 2:])):
        save_safetensors({k: weights[k] for k in part}, os.path.join(
            sdxl_dir, "unet", f"diffusion_pytorch_model-0000{shard + 1}-of-00002.safetensors"))
    write_s = time.perf_counter() - t0
    with torch.device(dev):
        vae = AutoencoderKL(VAEConfig.sdxl(), torch.bfloat16)
    os.makedirs(os.path.join(sdxl_dir, "vae"))
    save_safetensors(seeded_weights(vae_checkpoint_shapes(vae), gen),
                     os.path.join(sdxl_dir, "vae", "diffusion_pytorch_model.safetensors"))
    del vae
    for source, target in ((os.path.join(flux_dir, "text_encoder"), "text_encoder"),
                           (os.path.join(sd3_dir, "text_encoder_2"), "text_encoder_2"),
                           (os.path.join(flux_dir, "tokenizer"), "tokenizer")):
        _link_tree(source, os.path.join(sdxl_dir, target))
    files = {"unet_gb": file_bytes / 1e9, "unet_dtype": "float8_e4m3fn" if fp8 else "bfloat16", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "written_gb_before": written_before,
             "written_gb_after": _written_gb(), "free_gb_before": free / 1e9}

    # (c) import through load_transformer_params, every tensor bitwise the written one
    model = SDXL(config_namespace({"model_family": "sdxl", "model_type": "full"}))
    if model.arch != arch:
        raise RuntimeError(f"sdxl: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()  # model_type full: no adapters
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rss_before = _rss_gib()
    t0 = time.perf_counter()
    load_transformer_params(model, module, sdxl_dir)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    imported = {"s": load_s, "gb_per_s": file_bytes / load_s / 1e9, "host_rss_gib": {"before": rss_before,
                "after": _rss_gib()}, "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
                "params": sum(p.numel() for p in module.parameters())}
    expected = flax_to_state_dict(unet_params_from_diffusers(weights, arch), module)
    unequal = [k for k, v in module.state_dict().items() if not torch.equal(v, expected[k])]
    if unequal or imported["params"] != params:
        raise RuntimeError(f"sdxl: the imported module differs from the written tensors at {unequal[:8]} "
                           f"({imported['params']} parameters, {params} written)")
    imported["tensors_bitwise"] = len(expected)
    del weights, expected, module
    gc.collect()
    torch.cuda.empty_cache()

    # (d) 1024x1024 renders with true CFG through the checkpoint runtime: DDIM (the default), then UniPC
    config_path = os.path.join(work, "sdxl_render.json")
    with open(config_path, "w") as handle:
        json.dump({"model_family": "sdxl", "model_type": "full", "pretrained_model_name_or_path": sdxl_dir,
                   "mixed_precision": "bf16", "text_encoder_precision": "bf16", "vae_dtype": "bf16",
                   "validation_resolution": RESOLUTION, "validation_seed": 42, "seed": 42,
                   "validation_guidance": SDXL_GUIDANCE}, handle)
    t0 = time.perf_counter()
    runtime = CheckpointInferenceRuntime(config_path=config_path, output=os.path.join(work, "sdxl_render"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    module, model = runtime.module, runtime.model
    if model.arch != arch or model.NAME != "sdxl" or model.is_flow:
        raise RuntimeError(f"sdxl: the runtime built {model.NAME} {model.arch}")
    forward_s, finite = [], []

    def before(mod, args):
        torch.cuda.synchronize()
        forward_s.append(-time.perf_counter())

    def after(mod, args, out):
        torch.cuda.synchronize()
        forward_s[-1] += time.perf_counter()

    decode = runtime.vae.decode

    def decode_checked(z):
        finite.append(bool(torch.isfinite(z).all()))
        return decode(z)

    hooks = [module.register_forward_pre_hook(before), module.register_forward_hook(after)]
    runtime.vae.decode = decode_checked
    renders = {}
    # two attentions per transformer block: the down path's layers_per_block
    # and the up path's layers_per_block + 1 spatial transformers per level, and the mid one
    levels = len(arch.block_out_channels)
    per_forward = 2 * (sum(arch.depth_at(level) * (2 * arch.layers_per_block + 1)
                           for level in range(levels) if arch.cross_attention_blocks[level])
                       + arch.depth_at(levels - 1))
    for scheduler, cls in (("ddim", DDIMScheduler), ("unipc", UniPCScheduler)):
        runtime.config.validation_noise_scheduler = scheduler
        forward_s.clear()
        finite.clear()
        for kernel in kernels:
            kernel.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pngs = runtime.render(SDXL_PROMPT, steps=STEPS, guidance=SDXL_GUIDANCE)
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
        launches = {kernel.name: kernel.launches for kernel in kernels}
        if launches != {"flash_fwd": per_forward * 2 * STEPS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}:
            raise RuntimeError(f"sdxl render ({scheduler}): launches {launches}, expected {per_forward} per forward, "
                               "two forwards per step")
        if len(pngs) != 1 or finite != [True] or len(forward_s) != 2 * STEPS:
            raise RuntimeError(f"sdxl render ({scheduler}): {pngs}, finite latents {finite}, {len(forward_s)} forwards")
        check_png(pngs[0], RESOLUTION, RESOLUTION)
        if not isinstance(build_scheduler(model, STEPS), cls):
            raise RuntimeError(f"sdxl render: validation_noise_scheduler={scheduler} does not build {cls.__name__}")
        renders[scheduler] = {"render_s": render_s, "s_per_cfg_step": sum(forward_s[2:]) / (len(forward_s) - 2) * 2,
                              "forward_s": list(forward_s), "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                              "launches": launches, "png_bytes": os.path.getsize(pngs[0])}
    runtime.vae.decode = decode
    for hook in hooks:
        hook.remove()

    # (e) one full-depth UNet forward, kernels against the plain attention
    latent = RESOLUTION // 8
    batch = {"latents": torch.zeros((1, latent, latent, 4), device=dev)}
    for key, value in model.collate_text_embeds(model.encode_text([SDXL_PROMPT])).items():
        batch[key] = torch.as_tensor(value, device=dev)
    if tuple(batch["text_embeds"].shape) != (1, SDXL_TXT, 2048) or tuple(batch["pooled_embeds"].shape) != (1, 1280):
        raise RuntimeError(f"sdxl: text_embeds {tuple(batch['text_embeds'].shape)}, pooled "
                           f"{tuple(batch['pooled_embeds'].shape)}")
    model.text_encoders = []  # the plain attention's scores need the room
    gc.collect()
    torch.cuda.empty_cache()
    cond = model.inference_conditioning(batch)
    noise = torch.randn((1, latent, latent, 4), generator=gen, device=dev)
    t = torch.tensor(SDXL_PARITY_T)
    with torch.no_grad():
        kernel_eps = model.denoise_fn(module, cond)(noise, t)
        set_attention_backend("xla")
        try:
            plain_eps = model.denoise_fn(module, cond)(noise, t)
        finally:
            set_attention_backend("auto")
        forward_ms = cuda_ms(lambda: model.denoise_fn(module, cond)(noise, t), 3, warmup=1)
    parity = rel_l2(kernel_eps, plain_eps)
    if not (torch.isfinite(kernel_eps).all() and torch.isfinite(plain_eps).all() and parity <= PARITY_REL_L2):
        raise RuntimeError(f"sdxl full-depth parity: rel L2 {parity} (<= {PARITY_REL_L2})")
    del runtime, module, model, kernel_eps, plain_eps, batch, cond
    gc.collect()
    torch.cuda.empty_cache()

    # (f) Trainer.run(): bf16 base, rank-16 LoRA on the attention projections,
    # remat, min-SNR epsilon, one square bucket, graphed
    data = os.path.join(work, "sdxl_data")
    os.makedirs(data)
    source = os.path.join(work, "vae_cache", "data")
    for i, index in enumerate(range(0, 3 * SDXL_TRAIN_IMAGES, 3)):  # phase 16's square JPEGs
        name = f"img_{index:04d}.jpg"
        os.link(os.path.join(source, name), os.path.join(data, name))
        with open(os.path.join(data, f"img_{index:04d}.txt"), "w") as handle:
            handle.write(TRAIN_CAPTIONS[i])
    out = os.path.join(work, "sdxl_train")
    config = {
        "model_family": "sdxl", "model_type": "lora", "lora_rank": 16,
        "lora_target_modules": list(SDXL.DEFAULT_LORA_TARGET), "pretrained_model_name_or_path": sdxl_dir,
        "gradient_checkpointing": True, "snr_gamma": SDXL_SNR_GAMMA, "optimizer": "adamw", "learning_rate": 1e-4,
        "lr_scheduler": "constant", "mixed_precision": "bf16", "text_encoder_precision": "bf16", "vae_dtype": "bf16",
        "train_batch_size": 1, "resolution": RESOLUTION, "resolution_type": "pixel_area",
        "max_train_steps": SDXL_TRAIN_STEPS, "logging_steps": 1, "report_to": "jsonl", "seed": 42,
        "cache_dir": os.path.join(work, "sdxl_cache"), "output_dir": out, "checkpoint_frozen_base": "reference",
        "data_backend_config": [
            {"id": "train", "dataset_type": "image", "type": "local", "instance_data_dir": data,
             "resolution": RESOLUTION, "resolution_type": "pixel_area", "caption_strategy": "textfile",
             "cache_dir_vae": os.path.join(work, "sdxl_cache", "vae")},
            {"id": "embeds", "dataset_type": "text_embeds", "type": "local", "default": True,
             "cache_dir": os.path.join(work, "sdxl_cache", "text")},
        ],
    }
    for kernel in kernels:
        kernel.launches = 0
    trainer = Trainer(config=config, device="cuda")
    run_start = time.time()
    trainer.run()
    torch.cuda.synchronize()
    run_s = time.time() - run_start
    train_launches = {kernel.name: kernel.launches for kernel in kernels}
    with open(os.path.join(out, "simpletuner-tpu-metrics.jsonl")) as handle:
        metrics = [json.loads(line) for line in handle]
    losses = [m["loss"] for m in metrics]
    if [m["step"] for m in metrics] != list(range(1, SDXL_TRAIN_STEPS + 1)) or not all(np.isfinite(losses)) or \
            not all(m["grad_norm"] > 0 for m in metrics) or not all(train_launches.values()):
        raise RuntimeError(f"sdxl trainer: metrics {metrics}, launches {train_launches}")
    if len(trainer._graphs) != 1 or trainer.model.arch != arch or trainer.vae.config != VAEConfig.sdxl():
        raise RuntimeError(f"sdxl trainer: {len(trainer._graphs)} graphs, arch {trainer.model.arch}")
    targets = {name.rsplit("/", 2)[-2] for name in trainer._state.trainable}
    if targets != {"to_q", "to_k", "to_v", "to_out"}:
        raise RuntimeError(f"sdxl trainer: adapters on {targets}")
    captures = {c["step"] for c in trainer.capture_report}
    step_s = {m["step"]: m["time"] - prev["time"] for prev, m in zip(metrics, metrics[1:]) if m["step"] not in captures}
    median_s = float(np.median(list(step_s.values())))
    graphed = next(iter(trainer._graphs.values()))
    captured = {counter.name: count for counter, count in graphed.captured_launches.items()}
    profile = replay_launches(lambda: graphed(trainer._state, graphed.batch, trainer._generator), captured,
                              {kernel.name: kernel.name for kernel in kernels})
    recorded = profile["bucket_launches"]
    replayed = {kernel.name: recorded[kernel.name] for kernel in kernels}
    # every attention's forward, its recompute under remat, and its backward
    expected_launches = {"flash_fwd": 2 * per_forward, "flash_bwd_dq": per_forward, "flash_bwd_dkv": per_forward}
    if replayed != {k: captured[k] for k in replayed} or replayed != expected_launches:
        raise RuntimeError(f"sdxl trainer: the profiled replay launched {replayed}, the capture recorded "
                           f"{captured}, expected {expected_launches}")
    flops = sdxl_step_flops(arch, 1, latent, latent, SDXL_TXT)
    stages = trainer.stage_report
    phase("20 sdxl", config="UNetConfig.sdxl() (the JAX preset: attention at all three levels; the published SDXL "
          "UNet has none at level 0)", params=params, channels=list(arch.block_out_channels),
          transformer_depths=list(arch.transformer_layers), heads_of_64=[c // 64 for c in arch.block_out_channels],
          tokens={"text": SDXL_TXT, "image_per_level": [s for _, s in SDXL_LEVELS]},
          attention_per_forward=per_forward, files=files, imported=imported,
          render={"init_s": init_s, "steps": STEPS, "guidance": SDXL_GUIDANCE, **renders},
          parity={"rel_l2": parity, "bound": PARITY_REL_L2, "t": SDXL_PARITY_T, "forward_ms": forward_ms},
          train={"base": "bf16", "remat": "every resnet and spatial transformer", "lora_rank": 16,
                 "lora_targets": sorted(targets), "snr_gamma": SDXL_SNR_GAMMA,
                 "lora_params": sum(p.numel() for p in trainer._state.trainable.values()),
                 "losses": losses, "grad_norms": [m["grad_norm"] for m in metrics], "step_s": step_s,
                 "s_per_step_median": median_s, "flops_per_step": flops,
                 "mfu": flops / median_s / PEAK_BF16_FLOPS, "run_s": run_s,
                 "time_to_first_step_s": metrics[0]["time"] - run_start,
                 "capture_s": [c["seconds"] for c in trainer.capture_report],
                 "stage_s": {k: v["seconds"] for k, v in stages.items()},
                 "peak_gib": max(v["peak_gib"] for v in stages.values()),
                 "stage_peak_gib": {k: v["peak_gib"] for k, v in stages.items()},
                 "launches_run": train_launches, "launches_captured": captured, "launches_profiled_replay": replayed,
                 "profile": {k: profile[k] for k in ("bucket_ms", "bucket_launches", "launch_attempts", "device_ms", "traced_event_ms",
                                                     "idle_share_traced", "top_kernels")}},
          allocated_gib_before_phase=baseline_gib, written_gb=_written_gb(), seconds=time.perf_counter() - start,
          device=device)
    del trainer, graphed
    gc.collect()
    torch.cuda.empty_cache()


def pixart_step_flops(arch, batch: int, tokens: int, txt: int) -> float:
    """Model FLOPs of one PixArt train step in bench.py's convention (forward
    x 3), counted from the config at ``tokens`` image tokens and ``txt``
    caption tokens: the patch embedding, the caption projection, the
    timestep MLP and ``t6``, per block the self-attention's q, k, v and out,
    the cross-attention's q and out over the image tokens and k and v over
    the caption, both attentions' two products at the model's head dim (72,
    not the kernels' padded 128), the feed-forward, and the final projection."""
    dim, inner, p = arch.hidden_size, arch.num_heads * arch.head_dim, arch.patch_size
    ffn = int(dim * arch.ffn_ratio)
    fwd = 2.0 * tokens * p * p * arch.in_channels * dim
    fwd += 2.0 * txt * (arch.text_dim * dim + dim * dim)
    fwd += 2.0 * (256 * dim + dim * dim + dim * 6 * dim)
    per_block = 2.0 * tokens * dim * inner * 6 + 2.0 * txt * dim * inner * 2
    per_block += 4.0 * tokens * (tokens + txt) * inner + 2.0 * tokens * dim * ffn * 2
    fwd += arch.depth * per_block + 2.0 * tokens * dim * p * p * arch.effective_out_channels
    return batch * fwd * 3.0


def _phase21_files(family: str, paths: dict, gen) -> tuple:
    """The seeded fp8 base (two shards in ``unet/`` or ``transformer/``),
    SD 2.1's cut OpenCLIP-H, and hard links to phase 14's CLIP-L and
    tokenizer, phase 15's T5-XXL and its tokenizer and phase 20's 4-channel
    VAE: (model dir, arch, written fp8 tensors, file GB, write s)."""
    import dataclasses

    import torch

    from simpletuner_tpu_torch.models.checkpoint_layouts import (
        clip_checkpoint_shapes, pixart_checkpoint_shapes, unet_checkpoint_shapes,
    )
    from simpletuner_tpu_torch.models.clip import CLIPTextConfig
    from simpletuner_tpu_torch.models.pixart import PixartConfig
    from simpletuner_tpu_torch.models.unet import UNetConfig
    from simpletuner_tpu_torch.models.weight_import import save_safetensors

    work, flux_dir = paths["work"], paths["flux_dir"]
    model_dir = os.path.join(work, family)
    if family == "pixart_sigma":
        arch, sub = PixartConfig.sigma_1024(), "transformer"
        shapes = pixart_checkpoint_shapes(arch)
    else:
        arch, sub = (UNetConfig.sd15() if family == "sd1x" else UNetConfig.sd21()), "unet"
        shapes = unet_checkpoint_shapes(arch, conv_proj=family == "sd1x")  # SD 1.5's 1x1-conv proj_in / out
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 4e9 or written_before + file_bytes / 1e9 + 0.3 + _reserved(21) > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"{family}: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before; the "
                           f"base needs {file_bytes / 1e9:.2f} GB and the later phases {_reserved(21):.1f} GB of the "
                           f"{RUN_WRITE_TARGET_GB} GB a run may write")
    os.makedirs(os.path.join(model_dir, sub))
    weights = {k: v.to(torch.float8_e4m3fn) for k, v in seeded_weights(shapes, gen).items()}
    names = sorted(weights)
    t0 = time.perf_counter()
    for shard, part in enumerate((names[: len(names) // 2], names[len(names) // 2:])):
        save_safetensors({k: weights[k] for k in part}, os.path.join(
            model_dir, sub, f"diffusion_pytorch_model-0000{shard + 1}-of-00002.safetensors"))
    write_s = time.perf_counter() - t0
    links = [(os.path.join(work, "sdxl", "vae"), "vae")]
    if family == "sd1x":
        links += [(os.path.join(flux_dir, "text_encoder"), "text_encoder"), (os.path.join(flux_dir, "tokenizer"),
                                                                             "tokenizer")]
    elif family == "sd2x":
        clip_h = dataclasses.replace(CLIPTextConfig.open_clip_h(), num_hidden_layers=PHASE21_CLIP_H_LAYERS)
        os.makedirs(os.path.join(model_dir, "text_encoder"))
        save_safetensors(seeded_weights(clip_checkpoint_shapes(clip_h), gen),
                         os.path.join(model_dir, "text_encoder", "model.safetensors"))
        with open(os.path.join(model_dir, "text_encoder", "config.json"), "w") as handle:
            json.dump({**dataclasses.asdict(clip_h), "architectures": ["CLIPTextModel"]}, handle)
        links.append((os.path.join(flux_dir, "tokenizer"), "tokenizer"))
    else:
        # the T5 spec reads ``tokenizer_2`` when it names no tokenizer
        # subfolder, in both packages (a published PixArt dir has ``tokenizer``)
        links += [(os.path.join(flux_dir, "text_encoder_2"), "text_encoder"),
                  (os.path.join(flux_dir, "tokenizer_2"), "tokenizer_2")]
    for source, target in links:
        _link_tree(source, os.path.join(model_dir, target))
    return model_dir, arch, weights, file_bytes / 1e9, write_s


def ddpm_family_phase(family: str, resolution: int, guidance: float, train_extra: dict, paths: dict, kernels,
                      device: str) -> None:
    """Phase 21 for one family: the seeded files, the import bitwise, a true-CFG
    DDIM render through ``CheckpointInferenceRuntime``, one full-depth
    forward with the kernels against the plain attention, and 6 graphed LoRA
    steps through ``Trainer.run()`` with the launches of a profiled replay
    held to the capture's."""
    import gc

    import numpy as np
    import torch

    from simpletuner_tpu_torch.bench import replay_launches
    from simpletuner_tpu_torch.inference import CheckpointInferenceRuntime, config_namespace
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.vae import VAEConfig
    from simpletuner_tpu_torch.models.weight_bridge import flax_to_state_dict
    from simpletuner_tpu_torch.models.weight_import import (
        load_transformer_params, pixart_params_from_diffusers, unet_params_from_diffusers,
    )
    from simpletuner_tpu_torch.ops import set_attention_backend
    from simpletuner_tpu_torch.schedulers import DDIMScheduler
    from simpletuner_tpu_torch.training.trainer import Trainer
    from simpletuner_tpu_torch.training.validation import build_scheduler

    start = time.perf_counter()
    work = paths["work"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    pixart = family == "pixart_sigma"
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    written_before = _written_gb()
    model_dir, arch, weights, file_gb, write_s = _phase21_files(family, paths, gen)
    files = {"base_gb": file_gb, "base_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_gb / write_s, "written_gb_before": written_before,
             "written_gb_after": _written_gb()}

    # (c) import through load_transformer_params, every tensor bitwise the written one
    model = ModelRegistry.create(family, config_namespace({"model_family": family, "model_type": "full"}))
    if model.arch != arch:
        raise RuntimeError(f"{family}: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()  # model_type full: no adapters
    params = sum(p.numel() for p in module.parameters())
    torch.cuda.synchronize()
    rss_before = _rss_gib()
    t0 = time.perf_counter()
    load_transformer_params(model, module, model_dir)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    imported = {"s": load_s, "gb_per_s": file_gb / load_s, "params": params,
                "host_rss_gib": {"before": rss_before, "after": _rss_gib()}}
    importer = pixart_params_from_diffusers if pixart else unet_params_from_diffusers
    expected = flax_to_state_dict(importer(weights, arch), module)
    unequal = [k for k, v in module.state_dict().items() if not torch.equal(v, expected[k])]
    if unequal or params != sum(v.numel() for v in weights.values()):
        raise RuntimeError(f"{family}: the imported module differs from the written tensors at {unequal[:8]}")
    imported["tensors_bitwise"] = len(expected)
    del weights, expected, module
    gc.collect()
    torch.cuda.empty_cache()

    # (d) a true-CFG DDIM render through the checkpoint runtime
    config_path = os.path.join(work, f"{family}_render.json")
    with open(config_path, "w") as handle:
        json.dump({"model_family": family, "model_type": "full", "pretrained_model_name_or_path": model_dir,
                   "mixed_precision": "bf16", "text_encoder_precision": "bf16", "vae_dtype": "bf16",
                   "validation_resolution": resolution, "validation_seed": 42, "seed": 42,
                   "validation_guidance": guidance}, handle)
    t0 = time.perf_counter()
    runtime = CheckpointInferenceRuntime(config_path=config_path, output=os.path.join(work, f"{family}_render"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    module, model = runtime.module, runtime.model
    if model.arch != arch or model.NAME != family or model.is_flow:
        raise RuntimeError(f"{family}: the runtime built {model.NAME} {model.arch}")
    if not isinstance(build_scheduler(model, STEPS), DDIMScheduler):
        raise RuntimeError(f"{family}: the default scheduler is not DDIM")
    forward_s, finite = [], []

    def before(mod, args):
        torch.cuda.synchronize()
        forward_s.append(-time.perf_counter())

    def after(mod, args, out):
        torch.cuda.synchronize()
        forward_s[-1] += time.perf_counter()

    decode = runtime.vae.decode

    def decode_checked(z):
        finite.append(bool(torch.isfinite(z).all()))
        return decode(z)

    hooks = [module.register_forward_pre_hook(before), module.register_forward_hook(after)]
    runtime.vae.decode = decode_checked
    # two attentions per transformer block: the UNet's down path has
    # layers_per_block and the up path layers_per_block + 1 spatial
    # transformers per attention level, and one mid; PixArt's blocks
    if pixart:
        per_forward = 2 * arch.depth
    else:
        levels = len(arch.block_out_channels)
        per_forward = 2 * (sum(arch.depth_at(level) * (2 * arch.layers_per_block + 1)
                               for level in range(levels) if arch.cross_attention_blocks[level])
                           + arch.depth_at(levels - 1))
    for kernel in kernels:
        kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pngs = runtime.render(SDXL_PROMPT, steps=STEPS, guidance=guidance)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = {kernel.name: kernel.launches for kernel in kernels}
    runtime.vae.decode = decode
    for hook in hooks:
        hook.remove()
    if launches != {"flash_fwd": per_forward * 2 * STEPS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}:
        raise RuntimeError(f"{family} render: launches {launches}, expected {per_forward} per forward, two per step")
    if len(pngs) != 1 or finite != [True] or len(forward_s) != 2 * STEPS:
        raise RuntimeError(f"{family} render: {pngs}, finite latents {finite}, {len(forward_s)} forwards")
    check_png(pngs[0], resolution, resolution)
    render = {"init_s": init_s, "steps": STEPS, "guidance": guidance, "scheduler": "ddim",
              "prediction_type": model.prediction_type, "render_s": render_s,
              "s_per_cfg_step": sum(forward_s[2:]) / (len(forward_s) - 2) * 2, "forward_s": list(forward_s),
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
              "png_bytes": os.path.getsize(pngs[0])}

    # (e) one full-depth forward, kernels against the plain attention
    latent = resolution // 8
    txt = PHASE21_TXT[family]
    batch = {"latents": torch.zeros((1, latent, latent, 4), device=dev)}
    for key, value in model.collate_text_embeds(model.encode_text([SDXL_PROMPT])).items():
        batch[key] = torch.as_tensor(value, device=dev)
    width = arch.text_dim if pixart else arch.cross_attention_dim
    if tuple(batch["text_embeds"].shape) != (1, txt, width):
        raise RuntimeError(f"{family}: text_embeds {tuple(batch['text_embeds'].shape)}, expected (1, {txt}, {width})")
    model.text_encoders = []  # the plain attention's scores need the room
    gc.collect()
    torch.cuda.empty_cache()
    cond = model.inference_conditioning(batch)
    noise = torch.randn((1, latent, latent, 4), generator=gen, device=dev)
    t = torch.tensor(SDXL_PARITY_T)
    with torch.no_grad():
        kernel_out = model.denoise_fn(module, cond)(noise, t)
        set_attention_backend("xla")
        try:
            plain_out = model.denoise_fn(module, cond)(noise, t)
        finally:
            set_attention_backend("auto")
        forward_ms = cuda_ms(lambda: model.denoise_fn(module, cond)(noise, t), 3, warmup=1)
    parity = rel_l2(kernel_out, plain_out)
    if not (torch.isfinite(kernel_out).all() and torch.isfinite(plain_out).all() and parity <= PARITY_REL_L2):
        raise RuntimeError(f"{family} full-depth parity: rel L2 {parity} (<= {PARITY_REL_L2})")
    del runtime, module, model, kernel_out, plain_out, batch, cond
    gc.collect()
    torch.cuda.empty_cache()

    # (f) Trainer.run(): bf16 base, rank-16 LoRA on the attention projections,
    # every resnet / spatial transformer (UNet) or block (PixArt) checkpointed,
    # one square bucket, graphed
    data = os.path.join(work, f"{family}_data")
    os.makedirs(data)
    source = os.path.join(work, "vae_cache", "data")
    for i, index in enumerate(range(0, 3 * SDXL_TRAIN_IMAGES, 3)):  # phase 16's square JPEGs
        name = f"img_{index:04d}.jpg"
        os.link(os.path.join(source, name), os.path.join(data, name))
        with open(os.path.join(data, f"img_{index:04d}.txt"), "w") as handle:
            handle.write(TRAIN_CAPTIONS[i])
    out = os.path.join(work, f"{family}_train")
    cache = os.path.join(work, f"{family}_cache")
    # PixArt's attention projections by their diffusers names (its family
    # preset names no module of the JAX tree); the UNets' DEFAULT_LORA_TARGET
    targets = ["to_q", "to_k", "to_v", "to_out.0"] if pixart else ["to_q", "to_k", "to_v", "to_out"]
    config = {
        "model_family": family, "model_type": "lora", "lora_rank": 16, "lora_target_modules": targets,
        "pretrained_model_name_or_path": model_dir, "gradient_checkpointing": True, "optimizer": "adamw",
        "learning_rate": 1e-4, "lr_scheduler": "constant", "mixed_precision": "bf16",
        "text_encoder_precision": "bf16", "vae_dtype": "bf16", "train_batch_size": 1, "resolution": resolution,
        "resolution_type": "pixel_area", "max_train_steps": SDXL_TRAIN_STEPS, "logging_steps": 1,
        "report_to": "jsonl", "seed": 42, "cache_dir": cache, "output_dir": out,
        "checkpoint_frozen_base": "reference", **train_extra,
        "data_backend_config": [
            {"id": "train", "dataset_type": "image", "type": "local", "instance_data_dir": data,
             "resolution": resolution, "resolution_type": "pixel_area", "caption_strategy": "textfile",
             "cache_dir_vae": os.path.join(cache, "vae")},
            {"id": "embeds", "dataset_type": "text_embeds", "type": "local", "default": True,
             "cache_dir": os.path.join(cache, "text")},
        ],
    }
    for kernel in kernels:
        kernel.launches = 0
    trainer = Trainer(config=config, device="cuda")
    run_start = time.time()
    trainer.run()
    torch.cuda.synchronize()
    run_s = time.time() - run_start
    train_launches = {kernel.name: kernel.launches for kernel in kernels}
    with open(os.path.join(out, "simpletuner-tpu-metrics.jsonl")) as handle:
        metrics = [json.loads(line) for line in handle]
    losses = [m["loss"] for m in metrics]
    if [m["step"] for m in metrics] != list(range(1, SDXL_TRAIN_STEPS + 1)) or not all(np.isfinite(losses)) or \
            not all(m["grad_norm"] > 0 for m in metrics) or not all(train_launches.values()):
        raise RuntimeError(f"{family} trainer: metrics {metrics}, launches {train_launches}")
    if len(trainer._graphs) != 1 or trainer.model.arch != arch or trainer.vae.config != VAEConfig():
        raise RuntimeError(f"{family} trainer: {len(trainer._graphs)} graphs, arch {trainer.model.arch}, "
                           f"VAE {trainer.vae.config}")
    adapted = {name.rsplit("/", 2)[-2] for name in trainer._state.trainable}
    expected_targets = {f"{a}_{p}" for a in ("attn1", "attn2") for p in ("q", "k", "v", "proj")} if pixart \
        else {"to_q", "to_k", "to_v", "to_out"}
    if adapted != expected_targets:
        raise RuntimeError(f"{family} trainer: adapters on {adapted}")
    captures = {c["step"] for c in trainer.capture_report}
    step_s = {m["step"]: m["time"] - prev["time"] for prev, m in zip(metrics, metrics[1:]) if m["step"] not in captures}
    median_s = float(np.median(list(step_s.values())))
    graphed = next(iter(trainer._graphs.values()))
    captured = {counter.name: count for counter, count in graphed.captured_launches.items()}
    profile = replay_launches(lambda: graphed(trainer._state, graphed.batch, trainer._generator), captured,
                              {kernel.name: kernel.name for kernel in kernels})
    recorded = profile["bucket_launches"]
    replayed = {kernel.name: recorded[kernel.name] for kernel in kernels}
    # every attention's forward, its recompute under remat, and its backward
    expected_launches = {"flash_fwd": 2 * per_forward, "flash_bwd_dq": per_forward, "flash_bwd_dkv": per_forward}
    if replayed != {k: captured[k] for k in replayed} or replayed != expected_launches:
        raise RuntimeError(f"{family} trainer: the profiled replay launched {replayed}, the capture recorded "
                           f"{captured}, expected {expected_launches}")
    if pixart:
        flops = pixart_step_flops(arch, 1, (latent // arch.patch_size) ** 2, txt)
    else:
        flops = sdxl_step_flops(arch, 1, latent, latent, txt)
    stages = trainer.stage_report
    heads = [arch.num_heads] if pixart else [c // arch.attention_head_dim for c, a in
                                             zip(arch.block_out_channels, arch.cross_attention_blocks) if a]
    phase(f"21 {family}", config=repr(arch), params=params, resolution=resolution,
          heads=heads, head_dim=arch.head_dim if pixart else arch.attention_head_dim,
          tokens={"text": txt, "image_level0": (latent // (arch.patch_size if pixart else 1)) ** 2},
          attention_per_forward=per_forward, files=files, imported=imported, render=render,
          parity={"rel_l2": parity, "bound": PARITY_REL_L2, "t": SDXL_PARITY_T, "forward_ms": forward_ms},
          train={"base": "bf16", "remat": "every block" if pixart else "every resnet and spatial transformer",
                 "lora_rank": 16, "lora_targets": sorted(adapted), "prediction_type": trainer.model.prediction_type,
                 "extra": train_extra, "lora_params": sum(p.numel() for p in trainer._state.trainable.values()),
                 "losses": losses, "grad_norms": [m["grad_norm"] for m in metrics], "step_s": step_s,
                 "s_per_step_median": median_s, "flops_per_step": flops,
                 "mfu": flops / median_s / PEAK_BF16_FLOPS, "run_s": run_s,
                 "time_to_first_step_s": metrics[0]["time"] - run_start,
                 "capture_s": [c["seconds"] for c in trainer.capture_report],
                 "stage_s": {k: v["seconds"] for k, v in stages.items()},
                 "peak_gib": max(v["peak_gib"] for v in stages.values()),
                 "launches_run": train_launches, "launches_captured": captured, "launches_profiled_replay": replayed,
                 "profile": {k: profile[k] for k in ("bucket_ms", "bucket_launches", "launch_attempts", "device_ms", "traced_event_ms",
                                                     "idle_share_traced", "top_kernels")}},
          allocated_gib_before_phase=baseline_gib, written_gb=_written_gb(), seconds=time.perf_counter() - start,
          device=device)
    del trainer, graphed
    gc.collect()
    torch.cuda.empty_cache()


def ddpm_families_phase(paths: dict, kernels, device: str) -> None:
    """Phase 21: SD 1.5, SD 2.1 and PixArt-Sigma in turn (``PHASE21_MODELS``),
    after phase 20's UNet shards and outputs are deleted (disk space, not the
    write budget)."""
    work = paths["work"]
    for out in (os.path.join(work, "sdxl", "unet"), os.path.join(work, "sdxl_train"), os.path.join(work, "sdxl_cache")):
        shutil.rmtree(out, ignore_errors=True)
    for family, resolution, guidance, extra in PHASE21_MODELS:
        ddpm_family_phase(family, resolution, guidance, extra, paths, kernels, device)


def auraflow_step_flops(arch, batch: int, tokens: int, t5_tokens: int) -> int:
    """Model FLOPs of one AuraFlow train step in bench.py's convention
    (forward x 3; remat recompute is hardware work, not model work), counted
    from the config at ``tokens`` image and ``t5_tokens`` caption tokens (the
    register tokens join the caption): the patch and caption linears, the
    timestep MLP and every block's modulation linear (per sample), per token
    of each stream q, k, v, out and the SwiGLU feed-forward, each block's two
    attention products over the whole sequence at the model's head dim, and
    the final modulation and projection."""
    d, ffn, c = arch.hidden_size, arch.ffn_hidden, arch.in_channels * arch.patch_size ** 2
    seq = tokens + arch.num_register_tokens + t5_tokens
    blocks = arch.depth_double + arch.depth_single
    per_block = seq * 2 * d * (4 * d + 3 * ffn) + 4 * seq * seq * d
    modulation = 2 * d * 6 * d * (2 * arch.depth_double + arch.depth_single) + 2 * d * 2 * d
    fwd = 2 * tokens * c * d + 2 * t5_tokens * arch.text_dim * d + 2 * (256 * d + d * d) + modulation
    fwd += blocks * per_block + 2 * tokens * d * c
    return batch * fwd * 3


def _auraflow_flop_checks() -> list:
    """``auraflow_step_flops`` / 3 against ``torch.utils.flop_counter`` on
    the forward of two small configs on the CPU (f32; the attention through
    the plain version, whose two products the counter sees as bmm): equal."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from simpletuner_tpu_torch.models.auraflow import AuraFlowConfig, AuraFlowTransformer
    from simpletuner_tpu_torch.models.layers import init_parameters

    checks = []
    wider = AuraFlowConfig(hidden_size=96, depth_double=2, depth_single=1, num_heads=3, text_dim=48,
                           pos_embed_max_size=64)
    for arch, (height, width), t5_tokens in ((AuraFlowConfig.tiny(), (8, 8), 20), (wider, (8, 12), 11)):
        module = init_parameters(AuraFlowTransformer(arch, dtype=torch.float32), torch.Generator().manual_seed(0))
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            module(torch.zeros(2, height, width, 4), torch.full((2,), 0.5), torch.zeros(2, t5_tokens, arch.text_dim))
        tokens = (height // arch.patch_size) * (width // arch.patch_size)
        expected = auraflow_step_flops(arch, 2, tokens, t5_tokens) // 3
        if counter.get_total_flops() != expected:
            raise RuntimeError(f"auraflow_step_flops: {expected} forward FLOPs at {arch}, the counter "
                               f"{counter.get_total_flops()}")
        checks.append({"hidden": arch.hidden_size, "latent": [height, width], "flops": expected})
    return checks


def auraflow_phase(paths: dict, kernels, device: str, depth: tuple) -> dict:
    """Phase 22: AuraFlow v0.3 at its published size: a seeded e4m3 diffusers
    transformer and a seeded Pile-T5-XL (a umt5 file, cut to
    ``PHASE22_T5_LAYERS`` blocks) written with the port's writer beside hard
    links to phase 15's T5 tokenizer (``tokenizer_2``, the subfolder both
    packages' T5 spec reads) and phase 20's 4-channel VAE; the import held
    bitwise to the written tensors; a 1024 px true-CFG flow Euler render
    through ``CheckpointInferenceRuntime``; one full-depth forward with the
    head dim 256 kernels against the plain attention; 6 graphed LoRA steps
    through ``Trainer.run()`` on an int8 base, and the launches of a profiled
    replay held to the capture's, every flash launch a head dim 256 instance.
    Returns the replay's launches per kernel."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from simpletuner_tpu_torch.bench import replay_launches
    from simpletuner_tpu_torch.inference import CheckpointInferenceRuntime, config_namespace
    from simpletuner_tpu_torch.models.auraflow import AuraFlowConfig
    from simpletuner_tpu_torch.models.checkpoint_layouts import auraflow_checkpoint_shapes
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.t5 import T5Config, T5EncoderModel
    from simpletuner_tpu_torch.models.text_encoders import init_encoder
    from simpletuner_tpu_torch.models.vae import VAEConfig
    from simpletuner_tpu_torch.models.weight_bridge import flax_to_state_dict
    from simpletuner_tpu_torch.models.weight_import import (
        auraflow_params_from_diffusers, load_transformer_params, save_safetensors,
    )
    from simpletuner_tpu_torch.ops import set_attention_backend
    from simpletuner_tpu_torch.training.quantization import int8_matmul
    from simpletuner_tpu_torch.training.trainer import Trainer

    start = time.perf_counter()
    work, flux_dir = paths["work"], paths["flux_dir"]
    # phase 21's files and outputs: disk space (not the write budget)
    for family, _, _, _ in PHASE21_MODELS:
        for out in (family, f"{family}_train", f"{family}_cache", f"{family}_data", f"{family}_render"):
            shutil.rmtree(os.path.join(work, out), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    flop_checks = _auraflow_flop_checks()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    published = AuraFlowConfig()
    if (published.hidden_size, published.depth_double, published.depth_single, published.num_heads,
            published.head_dim) != (3072, 4, 32, 12, 256):
        raise RuntimeError(f"not AuraFlow v0.3's published transformer: {published}")
    arch = dataclasses.replace(published, depth_double=depth[0], depth_single=depth[1])
    shapes = auraflow_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 6e9 or written_before + file_bytes / 1e9 + 0.4 + _reserved(22) > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"auraflow: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the "
                           f"phase; it writes {file_bytes / 1e9 + 1.1:.1f} GB and the later phases "
                           f"{_reserved(22):.1f} GB of the {RUN_WRITE_TARGET_GB} GB a run may write")

    # (b) the seeded files: the transformer (two e4m3 shards; the position
    # table and the register tokens at their initialisation scales, N(0, 0.1)
    # and N(0, 0.02), which e4m3 holds), Pile-T5-XL at full width and a cut
    # depth as a umt5 file (a relative attention bias in every layer, which
    # the loader drops but layer 0's, as the Flax model does); hard links to
    # the rest
    aura_dir = os.path.join(work, "auraflow")
    os.makedirs(os.path.join(aura_dir, "transformer"))
    drawn = seeded_weights(shapes, gen)
    drawn["pos_embed.pos_embed"] = 0.1 * torch.randn(shapes["pos_embed.pos_embed"], generator=gen, device=dev)
    drawn["register_tokens"] = 0.02 * torch.randn(shapes["register_tokens"], generator=gen, device=dev)
    weights = {k: v.to(torch.float8_e4m3fn) for k, v in drawn.items()}
    del drawn
    names = sorted(weights)
    t0 = time.perf_counter()
    for shard, part in enumerate((names[: len(names) // 2], names[len(names) // 2:])):
        save_safetensors({k: weights[k] for k in part}, os.path.join(
            aura_dir, "transformer", f"diffusion_pytorch_model-0000{shard + 1}-of-00002.safetensors"))
    write_s = time.perf_counter() - t0
    t5_config = dataclasses.replace(T5Config.pile_xl(), num_layers=PHASE22_T5_LAYERS)
    with torch.device(dev):
        t5 = init_encoder(T5EncoderModel(t5_config, torch.bfloat16), gen)
    t5_state = dict(t5.state_dict())
    for layer in range(1, PHASE22_T5_LAYERS):
        t5_state[f"encoder.block.{layer}.layer.0.SelfAttention.relative_attention_bias.weight"] = (
            torch.randn((t5_config.relative_attention_num_buckets, t5_config.num_heads), generator=gen, device=dev)
            * t5_config.d_model ** -0.5).to(torch.bfloat16)
    os.makedirs(os.path.join(aura_dir, "text_encoder"))
    save_safetensors(t5_state, os.path.join(aura_dir, "text_encoder", "model.safetensors"))
    with open(os.path.join(aura_dir, "text_encoder", "config.json"), "w") as handle:
        json.dump({**dataclasses.asdict(t5_config), "model_type": "umt5", "architectures": ["UMT5EncoderModel"],
                   "dense_act_fn": "silu", "is_gated_act": True, "tie_word_embeddings": False}, handle)
    t5_params = sum(v.numel() for v in t5_state.values())
    del t5, t5_state
    for source, target in ((os.path.join(flux_dir, "tokenizer_2"), "tokenizer_2"),
                           (os.path.join(work, "sdxl", "vae"), "vae")):
        _link_tree(source, os.path.join(aura_dir, target))
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "pile_t5_params": t5_params,
             "pile_t5_layers": PHASE22_T5_LAYERS, "written_gb_before": written_before,
             "written_gb_after": _written_gb(), "free_gb_before": free / 1e9}

    # (c) import through load_transformer_params, every tensor bitwise the
    # written one taken to bf16 (exact for every e4m3 value)
    model = ModelRegistry.create("auraflow", config_namespace({"model_family": "auraflow", "model_type": "full"}))
    if model.arch != arch:
        raise RuntimeError(f"auraflow: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()  # model_type full: no adapters
    params = sum(p.numel() for p in module.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rss_before = _rss_gib()
    t0 = time.perf_counter()
    load_transformer_params(model, module, aura_dir)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    imported = {"s": load_s, "gb_per_s": file_bytes / load_s / 1e9, "params": params,
                "host_rss_gib": {"before": rss_before, "after": _rss_gib()},
                "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}
    expected = flax_to_state_dict(auraflow_params_from_diffusers(weights, arch), module)
    unequal = [k for k, v in module.state_dict().items() if not torch.equal(v, expected[k])]
    if unequal or params != sum(v.numel() for v in weights.values()):
        raise RuntimeError(f"auraflow: the imported module differs from the written tensors at {unequal[:8]}")
    imported["tensors_bitwise"] = len(expected)
    del weights, expected, module
    gc.collect()
    torch.cuda.empty_cache()

    # (d) a 1024x1024 true-CFG flow Euler render through the checkpoint runtime
    config_path = os.path.join(work, "auraflow_render.json")
    with open(config_path, "w") as handle:
        json.dump({"model_family": "auraflow", "model_type": "full", "pretrained_model_name_or_path": aura_dir,
                   "mixed_precision": "bf16", "text_encoder_precision": "bf16", "vae_dtype": "bf16",
                   "validation_resolution": RESOLUTION, "validation_seed": 42, "seed": 42,
                   "validation_guidance": AURA_GUIDANCE}, handle)
    t0 = time.perf_counter()
    runtime = CheckpointInferenceRuntime(config_path=config_path, output=os.path.join(work, "auraflow_render"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    module, model = runtime.module, runtime.model
    if model.arch != arch or model.NAME != "auraflow" or not model.is_flow:
        raise RuntimeError(f"auraflow: the runtime built {model.NAME} {model.arch}")
    encoder = model.text_encoders[0].model
    if encoder.config != t5_config or len(encoder.encoder.block) != PHASE22_T5_LAYERS:
        raise RuntimeError(f"auraflow: the runtime's text encoder is {encoder.config}, not the file's {t5_config}")
    forward_s, finite = [], []

    def before(mod, args):
        torch.cuda.synchronize()
        forward_s.append(-time.perf_counter())

    def after(mod, args, out):
        torch.cuda.synchronize()
        forward_s[-1] += time.perf_counter()

    decode = runtime.vae.decode

    def decode_checked(z):
        finite.append(bool(torch.isfinite(z).all()))
        return decode(z)

    hooks = [module.register_forward_pre_hook(before), module.register_forward_hook(after)]
    runtime.vae.decode = decode_checked
    per_forward = arch.depth_double + arch.depth_single
    for kernel in kernels:
        kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pngs = runtime.render(AURA_PROMPT, steps=STEPS, guidance=AURA_GUIDANCE)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    render_launches = {kernel.name: kernel.launches for kernel in kernels}
    render_peak = torch.cuda.max_memory_allocated() / 2**30
    runtime.vae.decode = decode
    for hook in hooks:
        hook.remove()
    if render_launches != {"flash_fwd": per_forward * 2 * STEPS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}:
        raise RuntimeError(f"auraflow render: launches {render_launches}, expected {per_forward} per forward, two "
                           f"forwards per step")
    if len(pngs) != 1 or finite != [True] or len(forward_s) != 2 * STEPS:
        raise RuntimeError(f"auraflow render: {pngs}, finite latents {finite}, {len(forward_s)} forwards")
    check_png(pngs[0], RESOLUTION, RESOLUTION)

    # (e) one full-depth forward, the head dim 256 kernels against the plain
    # attention (the file's modulation weights are drawn, so every gate is
    # open and attention reaches the output)
    latent = RESOLUTION // 8
    batch = {"latents": torch.zeros((1, latent, latent, 4), device=dev)}
    for key, value in model.collate_text_embeds(model.encode_text([AURA_PROMPT])).items():
        batch[key] = torch.as_tensor(value, device=dev)
    if tuple(batch["text_embeds"].shape) != (1, AURA_T5_LEN, arch.text_dim):
        raise RuntimeError(f"auraflow: text_embeds {tuple(batch['text_embeds'].shape)}, expected "
                           f"(1, {AURA_T5_LEN}, {arch.text_dim})")
    model.text_encoders = []  # the plain attention's scores need the room
    gc.collect()
    torch.cuda.empty_cache()
    cond = model.inference_conditioning(batch)
    noise = torch.randn((1, latent, latent, 4), generator=gen, device=dev)
    sigma = torch.tensor(AURA_SIGMA)
    with torch.no_grad():
        kernel_v = model.denoise_fn(module, cond)(noise, sigma)
        set_attention_backend("xla")
        try:
            plain_v = model.denoise_fn(module, cond)(noise, sigma)
        finally:
            set_attention_backend("auto")
        forward_ms = cuda_ms(lambda: model.denoise_fn(module, cond)(noise, sigma), 3, warmup=1)
    parity = rel_l2(kernel_v, plain_v)
    if not (torch.isfinite(kernel_v).all() and torch.isfinite(plain_v).all() and parity <= PARITY_REL_L2):
        raise RuntimeError(f"auraflow full-depth parity: rel L2 {parity} (<= {PARITY_REL_L2})")
    del runtime, module, model, kernel_v, plain_v, batch, cond
    gc.collect()
    torch.cuda.empty_cache()

    # (f) Trainer.run(): int8 base with quantized_matmul=full, every block
    # checkpointed, rank-16 LoRA on the attention projections by their
    # diffusers names, one square bucket, graphed
    data = os.path.join(work, "auraflow_data")
    os.makedirs(data)
    source = os.path.join(work, "vae_cache", "data")
    for i, index in enumerate(range(0, 3 * AURA_TRAIN_IMAGES, 3)):  # phase 16's square JPEGs
        name = f"img_{index:04d}.jpg"
        os.link(os.path.join(source, name), os.path.join(data, name))
        with open(os.path.join(data, f"img_{index:04d}.txt"), "w") as handle:
            handle.write(TRAIN_CAPTIONS[i])
    out = os.path.join(work, "auraflow_train")
    cache = os.path.join(work, "auraflow_cache")
    config = {
        "model_family": "auraflow", "model_type": "lora", "lora_rank": 16,
        "lora_target_modules": ["to_q", "to_k", "to_v", "to_out.0"], "pretrained_model_name_or_path": aura_dir,
        "base_model_precision": "int8-quanto", "quantized_matmul": "full", "gradient_checkpointing": True,
        "optimizer": "adamw", "learning_rate": 1e-4, "lr_scheduler": "constant", "mixed_precision": "bf16",
        "text_encoder_precision": "bf16", "vae_dtype": "bf16", "train_batch_size": 1, "resolution": RESOLUTION,
        "resolution_type": "pixel_area", "max_train_steps": AURA_TRAIN_STEPS, "logging_steps": 1,
        "report_to": "jsonl", "seed": 42, "cache_dir": cache, "output_dir": out,
        "checkpoint_frozen_base": "reference",
        "data_backend_config": [
            {"id": "train", "dataset_type": "image", "type": "local", "instance_data_dir": data,
             "resolution": RESOLUTION, "resolution_type": "pixel_area", "caption_strategy": "textfile",
             "cache_dir_vae": os.path.join(cache, "vae")},
            {"id": "embeds", "dataset_type": "text_embeds", "type": "local", "default": True,
             "cache_dir": os.path.join(cache, "text")},
        ],
    }
    for kernel in kernels:
        kernel.launches = 0
    int8_matmul.launches = 0
    trainer = Trainer(config=config, device="cuda")
    run_start = time.time()
    trainer.run()
    torch.cuda.synchronize()
    run_s = time.time() - run_start
    train_launches = {kernel.name: kernel.launches for kernel in kernels}
    with open(os.path.join(out, "simpletuner-tpu-metrics.jsonl")) as handle:
        metrics = [json.loads(line) for line in handle]
    losses = [m["loss"] for m in metrics]
    if [m["step"] for m in metrics] != list(range(1, AURA_TRAIN_STEPS + 1)) or not all(np.isfinite(losses)) or \
            not all(m["grad_norm"] > 0 for m in metrics) or not all(train_launches.values()):
        raise RuntimeError(f"auraflow trainer: metrics {metrics}, launches {train_launches}")
    if len(trainer._graphs) != 1 or trainer.model.arch != arch or trainer.vae.config != VAEConfig():
        raise RuntimeError(f"auraflow trainer: {len(trainer._graphs)} graphs, arch {trainer.model.arch}, "
                           f"VAE {trainer.vae.config}")
    adapted = {name.rsplit("/", 2)[-2] for name in trainer._state.trainable}
    if adapted != {"attn_q", "attn_k", "attn_v", "attn_proj"}:
        raise RuntimeError(f"auraflow trainer: adapters on {adapted}")
    captures = {c["step"] for c in trainer.capture_report}
    step_s = {m["step"]: m["time"] - prev["time"] for prev, m in zip(metrics, metrics[1:]) if m["step"] not in captures}
    median_s = float(np.median(list(step_s.values())))
    graphed = next(iter(trainer._graphs.values()))
    captured = {counter.name: count for counter, count in graphed.captured_launches.items()}
    profile = replay_launches(lambda: graphed(trainer._state, graphed.batch, trainer._generator), captured,
                              {kernel.name: kernel.name for kernel in kernels})
    recorded = profile["bucket_launches"]
    replayed = {kernel.name: recorded[kernel.name] for kernel in kernels}
    # every attention's forward, its recompute under remat, and its backward
    expected_launches = {"flash_fwd": 2 * per_forward, "flash_bwd_dq": per_forward, "flash_bwd_dkv": per_forward}
    instances = profile["flash_instances"]
    if replayed != {k: captured[k] for k in replayed} or replayed != expected_launches or \
            not all("<256," in name for name in instances):
        raise RuntimeError(f"auraflow trainer: the profiled replay launched {replayed} ({instances}), the capture "
                           f"recorded {captured}, expected {expected_launches} of the head dim 256 instances")
    latent_tokens = (latent // arch.patch_size) ** 2
    flops = auraflow_step_flops(arch, 1, latent_tokens, AURA_T5_LEN)
    stages = trainer.stage_report
    phase("22 auraflow", config="fal/AuraFlow-v0.3 transformer/config.json", params=params,
          hidden=arch.hidden_size, heads=[arch.num_heads, arch.head_dim], blocks=[arch.depth_double, arch.depth_single],
          depth=[[arch.depth_double, arch.depth_single], [published.depth_double, published.depth_single]],
          ffn_hidden=arch.ffn_hidden, tokens={"registers": arch.num_register_tokens, "text": AURA_T5_LEN,
                                              "image": latent_tokens, "sequence": AURA_S},
          files=files, imported=imported,
          render={"init_s": init_s, "render_s": render_s, "steps": STEPS, "guidance": AURA_GUIDANCE,
                  "s_per_cfg_step": sum(forward_s[2:]) / (len(forward_s) - 2) * 2, "forward_s": forward_s,
                  "peak_gib": render_peak, "launches": render_launches, "png": os.path.basename(pngs[0]),
                  "png_bytes": os.path.getsize(pngs[0])},
          parity={"rel_l2": parity, "bound": PARITY_REL_L2, "sigma": AURA_SIGMA, "forward_ms": forward_ms},
          train={"base": "int8", "quantized_matmul": "full", "remat": "every block", "lora_rank": 16,
                 "lora_targets": sorted(adapted),
                 "lora_params": sum(p.numel() for p in trainer._state.trainable.values()),
                 "losses": losses, "grad_norms": [m["grad_norm"] for m in metrics], "step_s": step_s,
                 "s_per_step_median": median_s, "flops_per_step": flops, "flop_checks": flop_checks,
                 "mfu": flops / median_s / PEAK_BF16_FLOPS, "run_s": run_s,
                 "time_to_first_step_s": metrics[0]["time"] - run_start,
                 "capture_s": [c["seconds"] for c in trainer.capture_report],
                 "stage_s": {k: v["seconds"] for k, v in stages.items()},
                 "peak_gib": max(v["peak_gib"] for v in stages.values()),
                 "launches_run": train_launches, "launches_captured": captured,
                 "launches_profiled_replay": replayed, "flash_instances": instances,
                 "int8_gemm_bucket": recorded["int8_gemm"],
                 "profile": {k: profile[k] for k in ("bucket_ms", "bucket_launches", "launch_attempts", "device_ms", "traced_event_ms",
                                                     "idle_share_traced", "top_kernels")}},
          allocated_gib_before_phase=baseline_gib, written_gb=_written_gb(), seconds=time.perf_counter() - start,
          device=device)
    del trainer, graphed
    gc.collect()
    torch.cuda.empty_cache()
    return replayed


def wan_step_flops(arch, batch: int, tokens: int, text_tokens: int) -> int:
    """Model FLOPs of one Wan train step in bench.py's convention (forward x
    3; remat recompute is hardware work, not model work), counted from the
    config at ``tokens`` video and ``text_tokens`` umT5 tokens: the patch
    linear, the two-layer text projection over every text token, the
    timestep MLP and ``time_proj`` (per sample), per block q, k, v and out of
    the self-attention and q and out of the cross-attention per video token,
    the cross-attention's k and v per text token, the feed-forward, the two
    products of each attention, and the final projection."""
    d, inner, ffn = arch.hidden_size, arch.num_heads * arch.head_dim, arch.ffn_hidden
    pt, ph, pw = arch.patch
    c_in, c_out = pt * ph * pw * arch.in_channels, pt * ph * pw * (arch.out_channels or arch.in_channels)
    per_block = (2 * tokens * 6 * d * inner + 2 * text_tokens * 2 * d * inner + 2 * tokens * 2 * d * ffn
                 + 4 * tokens * tokens * inner + 4 * tokens * text_tokens * inner)
    fwd = (2 * tokens * c_in * d + 2 * text_tokens * (arch.text_dim * d + d * d) + 2 * (256 * d + d * d)
           + 2 * d * 6 * d + arch.depth * per_block + 2 * tokens * d * c_out)
    return batch * fwd * 3


def _wan_flop_checks() -> list:
    """``wan_step_flops`` / 3 against ``torch.utils.flop_counter`` on the
    forward of two small configs on the CPU (f32; the attention through the
    plain version, whose two products the counter sees as bmm), the second
    with the I2V head (12 channels in, 4 out): equal."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.wan import WanConfig, WanTransformer

    checks = []
    wider = WanConfig(in_channels=12, out_channels=4, hidden_size=96, depth=2, num_heads=3, head_dim=32, text_dim=48,
                      axes_dim=(12, 10, 10))
    for arch, (frames, height, width), text in ((WanConfig.tiny(), (3, 4, 6), 5), (wider, (2, 6, 4), 7)):
        module = init_parameters(WanTransformer(arch, dtype=torch.float32), torch.Generator().manual_seed(0))
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            module(torch.zeros(2, frames, height, width, arch.in_channels), torch.full((2,), 0.5),
                   torch.zeros(2, text, arch.text_dim))
        tokens = frames * (height // 2) * (width // 2)
        expected = wan_step_flops(arch, 2, tokens, text) // 3
        if counter.get_total_flops() != expected:
            raise RuntimeError(f"wan_step_flops: {expected} forward FLOPs at {arch}, the counter "
                               f"{counter.get_total_flops()}")
        checks.append({"hidden": arch.hidden_size, "latent": [frames, height, width], "flops": expected})
    return checks


def _seeded_clip(seed: int, frames: int, height: int, width: int):
    """uint8 RGB frames (T, H, W, 3): a seeded colour gradient drifting by
    frame, with a little seeded noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
    out = np.empty((frames, height, width, 3), np.uint8)
    for t in range(frames):
        for c in range(3):
            wave = np.sin(xs / (40 + 17 * c) + ys / (55 + 9 * c) + phase[c] + 0.08 * t * (c + 1))
            out[t, :, :, c] = np.clip(127.5 + 110 * wave + rng.normal(0, 6, (height, width)), 0, 255)
    return out


def _per_shape(kernels, scale: int = 1) -> dict:
    """Each wrapper's launches by (heads, sq, sk, head dim) as "HxSqxSkxD", over ``scale``."""
    return {kernel.name: {"x".join(map(str, key)): n // scale for key, n in sorted(kernel.shape_launches.items())}
            for kernel in kernels}


def _write_e4m3_transformer(root: str, shapes: dict, gen, subfolder: str = "transformer", weights=None) -> tuple:
    """Seeded weights of ``shapes`` (or ``weights``) taken to e4m3 on the
    card, written with the port's writer as two diffusers shards under
    ``root/subfolder``; returns the weights and the write seconds."""
    import torch

    from simpletuner_tpu_torch.models.weight_import import save_safetensors

    os.makedirs(os.path.join(root, subfolder))
    weights = {k: v.to(torch.float8_e4m3fn) for k, v in (weights or seeded_weights(shapes, gen)).items()}
    names = sorted(weights)
    t0 = time.perf_counter()
    for shard, part in enumerate((names[: len(names) // 2], names[len(names) // 2:])):
        save_safetensors({k: weights[k] for k in part}, os.path.join(
            root, subfolder, f"diffusion_pytorch_model-0000{shard + 1}-of-00002.safetensors"))
    return weights, time.perf_counter() - t0


def _write_clips(data: str, count: int, frames: int, height: int, width: int, fps: int, seed: int) -> dict:
    """``count`` seeded clips as mp4 (OpenCV, mp4v) with ``TRAIN_CAPTIONS``
    beside them; returns their size and the seconds taken."""
    cv2 = importlib.import_module("cv2")  # the port imports OpenCV only where it reads or writes a clip
    os.makedirs(data)
    t0 = time.perf_counter()
    clip_bytes = 0
    for i in range(count):
        path = os.path.join(data, f"clip_{i}.mp4")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height))
        for frame in _seeded_clip(seed + i, frames, height, width):
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        writer.release()
        clip_bytes += os.path.getsize(path)
        with open(os.path.join(data, f"clip_{i}.txt"), "w") as handle:
            handle.write(TRAIN_CAPTIONS[i])
    return {"clips": count, "clip_mb": clip_bytes / count / 1e6, "clip_write_s": time.perf_counter() - t0,
            "route": "mp4 (cv2 " + cv2.__version__ + ")"}


def _mp4_frame_shapes(path: str) -> list:
    """The (H, W, 3) shape of every frame OpenCV reads back from ``path``."""
    cv2 = importlib.import_module("cv2")
    capture = cv2.VideoCapture(path)
    shapes = []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        shapes.append(frame.shape)
    capture.release()
    return shapes


def _timed_render(runtime, kernels, prompt: str, guidance: float) -> dict:
    """``runtime.render`` of ``prompt`` over ``STEPS`` steps, each DiT forward
    and the VAE decode timed (synchronised hooks), the latents checked
    finite, and the wrappers' launches counted from 0."""
    import torch

    module = runtime.module
    forward_s, finite, decode_s = [], [], []

    def before(mod, args):
        torch.cuda.synchronize()
        forward_s.append(-time.perf_counter())

    def after(mod, args, out):
        torch.cuda.synchronize()
        forward_s[-1] += time.perf_counter()

    decode = runtime.vae.decode

    def decode_checked(z):
        finite.append(bool(torch.isfinite(z).all()))
        t1 = time.perf_counter()
        frames = decode(z)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t1)
        return frames

    hooks = [module.register_forward_pre_hook(before), module.register_forward_hook(after)]
    runtime.vae.decode = decode_checked
    for kernel in kernels:
        kernel.launches = 0
        kernel.shape_launches.clear()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        rendered = runtime.render(prompt, steps=STEPS, guidance=guidance)
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
    finally:
        runtime.vae.decode = decode
        for hook in hooks:
            hook.remove()
    return {"rendered": rendered, "render_s": render_s, "forward_s": forward_s, "finite": finite,
            "decode_s": decode_s, "launches": {kernel.name: kernel.launches for kernel in kernels},
            "launches_by_shape": _per_shape(kernels), "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def _graphed_step(model, module, batch: dict, kernels) -> dict:
    """One LoRA step of ``model``'s ``module`` (built in memory) captured by
    ``jit_train_step`` on ``batch`` and replayed twice: capture seconds,
    replay seconds, the captured launches (in all and by shape, the wrappers
    counting the two warm-up steps and the capture), loss, grad norm and the
    peak since the caller's last reset."""
    import torch

    from simpletuner_tpu_torch.training.optimizers import get_optimizer
    from simpletuner_tpu_torch.training.schedules import get_lr_schedule
    from simpletuner_tpu_torch.training.train_state import build_train_step, create_train_state, jit_train_step

    schedule = get_lr_schedule(model.config, model.config.max_train_steps)
    tx = get_optimizer(model.config, schedule)
    state = create_train_state(model, module, tx, quantize_mode=model.base_precision)
    step_fn = build_train_step(model, tx, schedule)
    generator = torch.Generator(device="cuda").manual_seed(0)
    for kernel in kernels:
        kernel.launches = 0
        kernel.shape_launches.clear()
    t0 = time.perf_counter()
    graphed = jit_train_step(step_fn, state, batch, generator)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    replays = []
    for _ in range(2):
        t0 = time.perf_counter()
        state, metrics = graphed(state, batch, generator)
        torch.cuda.synchronize()
        replays.append(time.perf_counter() - t0)
    return {"capture_s": capture_s, "replay_s": replays, "s_per_step": min(replays),
            "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches_captured": {counter.name: count for counter, count in graphed.captured_launches.items()},
            "launches_per_step_by_shape": _per_shape(kernels, 3)}


def wan_phase(paths: dict, kernels, device: str, depth: int) -> dict:
    """Phase 23: Wan 2.1 T2V-1.3B at the JAX preset's full width and depth on
    its published 832 x 480 x 81 clip: a seeded e4m3 diffusers transformer
    written with the port's writer beside hard links to phase 15's T5-XXL
    (``text_encoder``) and T5 tokenizer (``tokenizer_2``, the subfolder both
    packages' T5 spec reads); two seeded clips written as mp4 with captions;
    the import held bitwise to the written tensors; ``Trainer.run()``
    (discovery of the video dataset, the text cache, the video VAE cache one
    clip at a time, 6 graphed LoRA steps on a bf16 base with every block
    checkpointed), the launches of a profiled replay held to the capture's;
    a true-CFG render through ``CheckpointInferenceRuntime`` at 480 px square
    and 81 frames, written as mp4 and read back; one full-depth forward with
    the kernels against the plain attention on a 17-frame clip; and one
    graphed LoRA step of the 14B I2V shape at 4 of its 40 blocks on an int8
    base.  Returns the launches per step of each kernel at each Wan shape."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from simpletuner_tpu_torch.bench import replay_launches
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import wan_checkpoint_shapes
    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.video_vae import VideoAutoencoderKL, VideoVAEConfig
    from simpletuner_tpu_torch.models.wan import Wan, WanConfig
    from simpletuner_tpu_torch.models.weight_bridge import flax_to_state_dict
    from simpletuner_tpu_torch.models.weight_import import load_transformer_params, wan_params_from_diffusers
    from simpletuner_tpu_torch.ops import set_attention_backend
    from simpletuner_tpu_torch.training.trainer import Trainer

    start = time.perf_counter()
    work, flux_dir = paths["work"], paths["flux_dir"]
    # phase 22's files and outputs: disk space (not the write budget)
    for out in ("auraflow", "auraflow_train", "auraflow_cache", "auraflow_data", "auraflow_render"):
        shutil.rmtree(os.path.join(work, out), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    flop_checks = _wan_flop_checks()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    arch = WanConfig.b1_3()
    if (arch.hidden_size, arch.depth, arch.num_heads, arch.head_dim, arch.ffn_hidden) != (1536, 30, 12, 128, 6144):
        raise RuntimeError(f"not the JAX preset of Wan 2.1 T2V-1.3B: {arch}")
    arch = dataclasses.replace(arch, depth=depth)
    latent_shape = (WAN_FRAMES - 1) // 4 + 1, WAN_HEIGHT // 8, WAN_WIDTH // 8
    if latent_shape[0] * (latent_shape[1] // 2) * (latent_shape[2] // 2) != WAN_TOKENS:
        raise RuntimeError(f"wan: {latent_shape} latents do not give {WAN_TOKENS} tokens")
    shapes = wan_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    target_gb = RUN_WRITE_TARGET_GB
    if free < file_bytes + 6e9 or written_before + file_bytes / 1e9 + 0.15 + _reserved(23) > target_gb:
        raise RuntimeError(f"wan: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the phase; it "
                           f"and the later phases write {file_bytes / 1e9 + 0.15 + _reserved(23):.1f} GB of the "
                           f"{target_gb} GB a run "
                           "may write")

    # (b) the seeded files: the transformer (two e4m3 shards), hard links to
    # phase 15's T5-XXL and T5 tokenizer, and two mp4 clips with captions
    wan_dir = os.path.join(work, "wan")
    weights, write_s = _write_e4m3_transformer(wan_dir, shapes, gen)
    for source, target in (("text_encoder_2", "text_encoder"), ("tokenizer_2", "tokenizer_2")):
        _link_tree(os.path.join(flux_dir, source), os.path.join(wan_dir, target))
    data = os.path.join(work, "wan_data")
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9,
             **_write_clips(data, WAN_CLIPS, WAN_FRAMES, WAN_HEIGHT, WAN_WIDTH, 16, 0),
             "written_gb_before": written_before, "written_gb_after": _written_gb(), "free_gb_before": free / 1e9}

    # (c) import through load_transformer_params, every tensor bitwise the
    # written one taken to bf16 (exact for every e4m3 value)
    model = ModelRegistry.create("wan", config_namespace({"model_family": "wan", "model_type": "full"}))
    if model.arch != arch:
        raise RuntimeError(f"wan: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()  # model_type full: no adapters
    params = sum(p.numel() for p in module.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rss_before = _rss_gib()
    t0 = time.perf_counter()
    load_transformer_params(model, module, wan_dir)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    imported = {"s": load_s, "gb_per_s": file_bytes / load_s / 1e9, "params": params,
                "host_rss_gib": {"before": rss_before, "after": _rss_gib()},
                "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}
    expected = flax_to_state_dict(wan_params_from_diffusers(weights, arch), module)
    unequal = [k for k, v in module.state_dict().items() if not torch.equal(v, expected[k])]
    if unequal or params != sum(v.numel() for v in weights.values()):
        raise RuntimeError(f"wan: the imported module differs from the written tensors at {unequal[:8]}")
    imported["tensors_bitwise"] = len(expected)
    del weights, expected, module
    gc.collect()
    torch.cuda.empty_cache()

    # (d) Trainer.run(): discovery, the text cache and the video VAE cache
    # (one clip per encode), then rank-16 LoRA on the attention projections
    # by their diffusers names, bf16 base, every block checkpointed, graphed
    out = os.path.join(work, "wan_train")
    cache = os.path.join(work, "wan_cache")
    config = _video_config("wan", wan_dir, data, cache, out, WAN_FRAMES, WAN_TRAIN_STEPS,
                           lora_target_modules=["to_q", "to_k", "to_v", "to_out.0"])
    for kernel in kernels:
        kernel.launches = 0
        kernel.shape_launches.clear()
    trainer = Trainer(config=config, device="cuda")
    run_start = time.time()
    trainer.run()
    torch.cuda.synchronize()
    run_s = time.time() - run_start
    train_launches = {kernel.name: kernel.launches for kernel in kernels}
    shape_launches = _per_shape(kernels, 3)  # two warm-up steps and the capture
    with open(os.path.join(out, "simpletuner-tpu-metrics.jsonl")) as handle:
        metrics = [json.loads(line) for line in handle]
    losses = [m["loss"] for m in metrics]
    if [m["step"] for m in metrics] != list(range(1, WAN_TRAIN_STEPS + 1)) or not all(np.isfinite(losses)) or \
            not all(m["grad_norm"] > 0 for m in metrics) or not all(train_launches.values()):
        raise RuntimeError(f"wan trainer: metrics {metrics}, launches {train_launches}")
    bundle = trainer.data_plane.bundles["clips"]
    bucket_keys = sorted(bundle.metadata_backend.aspect_ratio_bucket_indices)
    clips = bundle.metadata_backend.aspect_ratio_bucket_indices.get(f"1.73x{WAN_FRAMES}", [])
    if len(trainer._graphs) != 1 or trainer.model.arch != arch or bucket_keys != [f"1.73x{WAN_FRAMES}"] or \
            len(clips) != WAN_CLIPS or not isinstance(trainer.vae, VideoAutoencoderKL) or \
            trainer.vae.config != VideoVAEConfig.wan():
        raise RuntimeError(f"wan trainer: {len(trainer._graphs)} graphs, arch {trainer.model.arch}, buckets "
                           f"{bucket_keys}, VAE {type(trainer.vae).__name__}")
    cached = [bundle.vae_cache.load(p) for p in clips]
    if any(c.shape != latent_shape + (16,) or not np.isfinite(c).all() for c in cached):
        raise RuntimeError(f"wan trainer: cached latents {[c.shape for c in cached]}, expected {latent_shape}")
    adapted = {name.rsplit("/", 2)[-2] for name in trainer._state.trainable}
    if adapted != {f"{a}_{p}" for a in ("self_attn", "cross_attn") for p in ("q", "k", "v", "proj")}:
        raise RuntimeError(f"wan trainer: adapters on {adapted}")
    captures = {c["step"] for c in trainer.capture_report}
    step_s = {m["step"]: m["time"] - prev["time"] for prev, m in zip(metrics, metrics[1:]) if m["step"] not in captures}
    median_s = float(np.median(list(step_s.values())))
    graphed = next(iter(trainer._graphs.values()))
    captured = {counter.name: count for counter, count in graphed.captured_launches.items()}
    profile = replay_launches(lambda: graphed(trainer._state, graphed.batch, trainer._generator), captured,
                              {kernel.name: kernel.name for kernel in kernels})
    recorded = profile["bucket_launches"]
    replayed = {kernel.name: recorded[kernel.name] for kernel in kernels}
    # every attention's forward, its recompute under remat, and its backward: two attentions a block
    per_forward = 2 * arch.depth
    expected_launches = {"flash_fwd": 2 * per_forward, "flash_bwd_dq": per_forward, "flash_bwd_dkv": per_forward}
    self_key, cross_key = f"12x{WAN_TOKENS}x{WAN_TOKENS}x128", f"12x{WAN_TOKENS}x{WAN_TEXT}x128"
    if replayed != {k: captured[k] for k in replayed} or replayed != expected_launches or \
            {k: 3 * v for k, v in replayed.items()} != train_launches or \
            any(set(shape_launches[k]) != {self_key, cross_key} or shape_launches[k][self_key] !=
                shape_launches[k][cross_key] for k in replayed):
        raise RuntimeError(f"wan trainer: the profiled replay launched {replayed}, the capture recorded {captured}, "
                           f"the run {train_launches} ({shape_launches}), expected {expected_launches} a step")
    flops = wan_step_flops(arch, 1, WAN_TOKENS, WAN_TEXT)
    stages, startup = trainer.stage_report, trainer.data_plane.startup_metrics
    train = {"base": "bf16", "remat": "every block", "lora_rank": 16, "lora_targets": sorted(adapted),
             "lora_params": sum(p.numel() for p in trainer._state.trainable.values()),
             "buckets": bucket_keys, "latents": list(cached[0].shape),
             "cache": {"text_s": startup.get("text_cache_clips_s"), "vae_s": startup.get("vae_cache_clips_s"),
                       "vae_s_per_clip": startup.get("vae_cache_clips_s", 0.0) / WAN_CLIPS,
                       "init_data_backend_peak_gib": stages["init_data_backend"]["peak_gib"]},
             "losses": losses, "grad_norms": [m["grad_norm"] for m in metrics], "step_s": step_s,
             "s_per_step_median": median_s, "flops_per_step": flops, "flop_checks": flop_checks,
             "mfu": flops / median_s / PEAK_BF16_FLOPS, "run_s": run_s,
             "time_to_first_step_s": metrics[0]["time"] - run_start,
             "capture_s": [c["seconds"] for c in trainer.capture_report],
             "stage_s": {k: v["seconds"] for k, v in stages.items()},
             "peak_gib": max(v["peak_gib"] for v in stages.values()),
             "launches_run": train_launches, "launches_captured": captured, "launches_profiled_replay": replayed,
             "launches_per_step_by_shape": shape_launches, "flash_instances": profile["flash_instances"],
             "profile": {k: profile[k] for k in ("bucket_ms", "bucket_launches", "launch_attempts", "device_ms", "traced_event_ms",
                                                 "idle_share_traced", "top_kernels")}}
    text_payload = bundle.text_cache.get(TRAIN_CAPTIONS[0])
    del trainer, graphed, bundle
    gc.collect()
    torch.cuda.empty_cache()

    # (e) a true-CFG flow Euler render at 480 px square and 81 frames through
    # the checkpoint runtime, written as mp4 and read back
    render, runtime = _video_render(work, "wan", wan_dir, "wan", kernels, WAN_PROMPT, WAN_GUIDANCE, WAN_RENDER_SIZE,
                                    WAN_FRAMES, per_forward)
    module, model = runtime.module, runtime.model
    if model.arch != arch or model.NAME != "wan" or not model.is_flow:
        raise RuntimeError(f"wan: the runtime built {model.NAME} {model.arch}")
    render["tokens"] = latent_shape[0] * (WAN_RENDER_SIZE // 16) ** 2

    # (f) one full-depth forward, the kernels against the plain attention, on
    # a 17-frame clip (5 x 30 x 52 = 7,800 tokens: the plain scores fit)
    parity_latent = ((WAN_PARITY_FRAMES - 1) // 4 + 1, latent_shape[1], latent_shape[2])
    batch = {"latents": torch.zeros((1,) + parity_latent + (16,), device=dev)}
    for key, value in model.collate_text_embeds(model.encode_text([WAN_PROMPT])).items():
        batch[key] = torch.as_tensor(value, device=dev)
    if tuple(batch["text_embeds"].shape) != (1, WAN_TEXT, arch.text_dim):
        raise RuntimeError(f"wan: text_embeds {tuple(batch['text_embeds'].shape)}, expected "
                           f"(1, {WAN_TEXT}, {arch.text_dim})")
    model.text_encoders = []  # the plain attention's scores need the room
    gc.collect()
    torch.cuda.empty_cache()
    cond = model.inference_conditioning(batch)
    noise = torch.randn((1,) + parity_latent + (16,), generator=gen, device=dev)
    sigma = torch.tensor(WAN_SIGMA)
    with torch.no_grad():
        kernel_v = model.denoise_fn(module, cond)(noise, sigma)
        set_attention_backend("xla")
        try:
            plain_v = model.denoise_fn(module, cond)(noise, sigma)
        finally:
            set_attention_backend("auto")
        forward_ms = cuda_ms(lambda: model.denoise_fn(module, cond)(noise, sigma), 3, warmup=1)
    parity = rel_l2(kernel_v, plain_v)
    if not (torch.isfinite(kernel_v).all() and torch.isfinite(plain_v).all() and parity <= PARITY_REL_L2):
        raise RuntimeError(f"wan full-depth parity: rel L2 {parity} (<= {PARITY_REL_L2})")
    parity_tokens = parity_latent[0] * (parity_latent[1] // 2) * (parity_latent[2] // 2)
    del runtime, module, model, kernel_v, plain_v, batch, cond
    gc.collect()
    torch.cuda.empty_cache()

    # (g) the 14B I2V shape (i2v-14b-480p: 5120 wide, 40 heads of 128, 36
    # channels in, 16 out) at WAN14B_BLOCKS of its 40 blocks, built in memory
    # from seeded weights: an int8 base (quantized_matmul full), every block
    # checkpointed, rank 16 on the attention projections, one graphed step on
    # the first clip's cached latents and its caption's umT5 features
    values = {"model_family": "wan", "model_flavour": "i2v-14b-480p", "model_type": "lora", "lora_rank": 16,
              "lora_target_modules": ["to_q", "to_k", "to_v", "to_out.0"], "base_model_precision": "int8-quanto",
              "quantized_matmul": "full", "gradient_checkpointing": True, "optimizer": "adamw", "learning_rate": 1e-4,
              "lr_scheduler": "constant", "max_train_steps": 10, "mixed_precision": "bf16"}
    cfg14 = config_namespace(values)
    arch14 = dataclasses.replace(WanConfig.b14(), depth=WAN14B_BLOCKS, in_channels=36, out_channels=16)
    model14 = Wan(cfg14, arch=arch14)
    if not model14.is_i2v or model14.latent_channels != 16 or \
            dataclasses.replace(Wan(config_namespace(values)).arch, depth=WAN14B_BLOCKS) != arch14:
        raise RuntimeError(f"wan 14B: the i2v-14b-480p flavour builds {Wan(config_namespace(values)).arch}")
    torch.cuda.reset_peak_memory_stats()
    with torch.device(dev):
        module14 = init_parameters(model14.create_module(), gen)
    params14 = sum(p.numel() for p in module14.parameters())
    batch = {"latents": torch.as_tensor(cached[0], device=dev)[None],
             "text_embeds": torch.as_tensor(text_payload["text_embeds"], device=dev)[None]}
    step14 = _graphed_step(model14, module14, batch, kernels)
    captured14, shapes14 = step14["launches_captured"], step14["launches_per_step_by_shape"]
    per_forward14 = 2 * WAN14B_BLOCKS
    key14 = f"40x{WAN_TOKENS}x{WAN_TOKENS}x128"
    if {k.name: captured14[k.name] for k in kernels} != {"flash_fwd": 2 * per_forward14,
                                                         "flash_bwd_dq": per_forward14,
                                                         "flash_bwd_dkv": per_forward14} or \
            not (np.isfinite(step14["loss"]) and step14["grad_norm"] > 0) or \
            any(shapes14[k.name].get(key14) != captured14[k.name] // 2 for k in kernels):
        raise RuntimeError(f"wan 14B: captured {captured14} ({shapes14}), loss {step14['loss']}, grad norm "
                           f"{step14['grad_norm']}")
    flops14 = wan_step_flops(arch14, 1, WAN_TOKENS, WAN_TEXT)
    i2v = {"flavour": "i2v-14b-480p", "blocks": [WAN14B_BLOCKS, 40], "hidden": arch14.hidden_size,
           "heads": [arch14.num_heads, arch14.head_dim], "channels": [arch14.in_channels, arch14.out_channels],
           "params": params14, "base": "int8", "quantized_matmul": "full", "flops_per_step": flops14,
           "mfu": flops14 / step14["s_per_step"] / PEAK_BF16_FLOPS, **step14}
    del module14, model14, batch
    gc.collect()
    torch.cuda.empty_cache()
    phase("23 wan", config="Wan-AI/Wan2.1-T2V-1.3B-Diffusers as the JAX preset WanConfig.b1_3 builds it (FFN 4 x 1536)",
          params=params, hidden=arch.hidden_size, heads=[arch.num_heads, arch.head_dim], blocks=arch.depth,
          depth=[arch.depth, WanConfig.b1_3().depth],
          ffn_hidden=arch.ffn_hidden, clip=[WAN_FRAMES, WAN_HEIGHT, WAN_WIDTH], latents=list(latent_shape),
          tokens={"video": WAN_TOKENS, "text": WAN_TEXT}, files=files, imported=imported, train=train,
          render=render, parity={"rel_l2": parity, "bound": PARITY_REL_L2, "sigma": WAN_SIGMA,
                                 "frames": WAN_PARITY_FRAMES, "tokens": parity_tokens, "forward_ms": forward_ms},
          i2v_14b=i2v, depth_cut=f"i2v-14b-480p at {WAN14B_BLOCKS} of its 40 blocks",
          allocated_gib_before_phase=baseline_gib, written_gb=_written_gb(), seconds=time.perf_counter() - start,
          device=device)
    return {"wan_self": {k: v.get(self_key) for k, v in shape_launches.items()},
            "wan_cross": {k: v.get(cross_key) for k, v in shape_launches.items()},
            "wan14b_self": {k: v.get(key14) for k, v in shapes14.items()}}

def ltx_step_flops(arch, batch: int, tokens: int, text_tokens: int, timestep_rows: int = 1) -> int:
    """Model FLOPs of one LTX-Video train step in bench.py's convention
    (forward x 3; remat recompute is hardware work, not model work), counted
    from the config at ``tokens`` video and ``text_tokens`` T5 tokens: the
    patch linear, the caption MLP over every text token, the timestep MLP and
    ``time_proj`` once per timestep row (one per sample, or one per latent
    frame on the per-frame path: ``timestep_rows``), per block q, k, v and out
    of the self-attention and q and out of the cross-attention per video
    token, the cross-attention's k and v per text token, the feed-forward, the
    two products of each attention, and the final projection."""
    d, inner, ffn = arch.hidden_size, arch.num_heads * arch.head_dim, arch.ffn_hidden
    per_block = (2 * tokens * 6 * d * inner + 2 * text_tokens * 2 * d * inner + 2 * tokens * 2 * d * ffn
                 + 4 * tokens * tokens * inner + 4 * tokens * text_tokens * inner)
    fwd = (2 * tokens * arch.in_channels * d + 2 * text_tokens * (arch.text_dim * d + d * d)
           + timestep_rows * (2 * (256 * d + d * d) + 2 * d * 6 * d) + arch.depth * per_block
           + 2 * tokens * d * arch.out_channels)
    return batch * fwd * 3


def _ltx_flop_checks() -> list:
    """``ltx_step_flops`` / 3 against ``torch.utils.flop_counter`` on the
    forward of two small configs on the CPU (f32; the attention through the
    plain version, whose two products the counter sees as bmm): the tiny
    config with per-sample timesteps, and a wider one (inner 96, so the RoPE
    tables pad) with per-frame timesteps: equal."""
    import dataclasses

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.ltxvideo import LTXConfig, LTXTransformer

    checks = []
    wider = dataclasses.replace(LTXConfig.tiny(), in_channels=12, out_channels=12, hidden_size=96, num_heads=3,
                                text_dim=48)
    for arch, (frames, height, width), text, per_frame in ((LTXConfig.tiny(), (3, 4, 6), 5, False),
                                                           (wider, (2, 6, 4), 7, True)):
        module = init_parameters(LTXTransformer(arch, dtype=torch.float32), torch.Generator().manual_seed(0))
        timesteps = torch.full((2, frames) if per_frame else (2,), 0.5)
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            module(torch.zeros(2, frames, height, width, arch.in_channels), timesteps,
                   torch.zeros(2, text, arch.text_dim))
        tokens = frames * height * width
        expected = ltx_step_flops(arch, 2, tokens, text, frames if per_frame else 1) // 3
        if counter.get_total_flops() != expected:
            raise RuntimeError(f"ltx_step_flops: {expected} forward FLOPs at {arch}, the counter "
                               f"{counter.get_total_flops()}")
        checks.append({"hidden": arch.hidden_size, "latent": [frames, height, width], "per_frame": per_frame,
                       "flops": expected})
    return checks


def ltx_phase(paths: dict, kernels, device: str, depth: int) -> dict:
    """Phase 24: LTX-Video 0.9.5 2B at the JAX preset's full width and depth
    on 768 x 512 x 121 clips: a seeded e4m3 diffusers transformer written with
    the port's writer beside hard links to phase 15's T5-XXL
    (``text_encoder``) and T5 tokenizer (``tokenizer_2``, the subfolder both
    packages' T5 spec reads); two seeded clips written as mp4 with captions;
    the import held bitwise to the written tensors; ``Trainer.run()``
    (discovery of the video dataset, the text cache, the video VAE cache at
    LTX's config one clip at a time, 6 graphed LoRA steps on a bf16 base with
    every block checkpointed and the default ``ltx_i2v_prob``, so the
    per-frame timesteps), the launches of a profiled replay held to the
    capture's; a true-CFG render through ``CheckpointInferenceRuntime`` at
    512 px square and 121 frames, written as mp4 and read back; one
    full-depth forward with the kernels against the plain attention on the
    training clip's latent grid; and one graphed LoRA step of the 13B width
    at 4 of its 48 blocks on an int8 base.  Returns the launches per step
    of each kernel at each LTX shape."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from simpletuner_tpu_torch.bench import replay_launches
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import ltx_checkpoint_shapes
    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.ltxvideo import LTXConfig, LTXTransformer, LTXVideo
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.video_vae import VideoAutoencoderKL
    from simpletuner_tpu_torch.models.weight_bridge import flax_to_state_dict
    from simpletuner_tpu_torch.models.weight_import import load_transformer_params, ltx_params_from_diffusers
    from simpletuner_tpu_torch.ops import set_attention_backend
    from simpletuner_tpu_torch.training.trainer import Trainer

    start = time.perf_counter()
    work, flux_dir = paths["work"], paths["flux_dir"]
    # phase 23's files and outputs: disk space (not the write budget)
    for out in ("wan", "wan_train", "wan_cache", "wan_data", "wan_render"):
        shutil.rmtree(os.path.join(work, out), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    flop_checks = _ltx_flop_checks()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    arch = LTXConfig()
    if (arch.hidden_size, arch.depth, arch.num_heads, arch.head_dim, arch.ffn_hidden, arch.in_channels) != \
            (2048, 28, 32, 64, 8192, 128):
        raise RuntimeError(f"not the JAX preset of LTX-Video 0.9.5 2B: {arch}")
    arch = dataclasses.replace(arch, depth=depth)
    shapes = ltx_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    target_gb = RUN_WRITE_TARGET_GB
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 6e9 or written_before + file_bytes / 1e9 + 0.15 + _reserved(24) > target_gb:
        raise RuntimeError(f"ltx: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the phase; it "
                           f"and the later phases write {file_bytes / 1e9 + 0.15 + _reserved(24):.1f} GB of the "
                           f"{target_gb} GB a run may write")

    # (b) the seeded files: the transformer (two e4m3 shards), hard links to
    # phase 15's T5-XXL and T5 tokenizer, and two mp4 clips with captions
    ltx_dir = os.path.join(work, "ltx")
    weights, write_s = _write_e4m3_transformer(ltx_dir, shapes, gen)
    for source, target in (("text_encoder_2", "text_encoder"), ("tokenizer_2", "tokenizer_2")):
        _link_tree(os.path.join(flux_dir, source), os.path.join(ltx_dir, target))
    data = os.path.join(work, "ltx_data")
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9,
             **_write_clips(data, LTX_CLIPS, LTX_FRAMES, LTX_HEIGHT, LTX_WIDTH, 24, 100),
             "written_gb_before": written_before, "written_gb_after": _written_gb(), "free_gb_before": free / 1e9}
    paths["ltx_clips"] = data  # phase 46 links them

    # (c) import through load_transformer_params, every tensor bitwise the
    # written one taken to bf16 (exact for every e4m3 value)
    model = ModelRegistry.create("ltxvideo", config_namespace({"model_family": "ltxvideo", "model_type": "full"}))
    if model.arch != arch or model.flavour != "2b-0.9.5":
        raise RuntimeError(f"ltx: the family builds {model.flavour} {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()  # model_type full: no adapters
    params = sum(p.numel() for p in module.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rss_before = _rss_gib()
    t0 = time.perf_counter()
    load_transformer_params(model, module, ltx_dir)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    imported = {"s": load_s, "gb_per_s": file_bytes / load_s / 1e9, "params": params,
                "host_rss_gib": {"before": rss_before, "after": _rss_gib()},
                "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}
    expected = flax_to_state_dict(ltx_params_from_diffusers(weights, arch), module)
    unequal = [k for k, v in module.state_dict().items() if not torch.equal(v, expected[k])]
    if unequal or params != sum(v.numel() for v in weights.values()):
        raise RuntimeError(f"ltx: the imported module differs from the written tensors at {unequal[:8]}")
    imported["tensors_bitwise"] = len(expected)
    del weights, expected, module
    gc.collect()
    torch.cuda.empty_cache()

    # (d) Trainer.run(): discovery, the text cache and the video VAE cache at
    # LTX's config (one clip per encode), then rank-16 LoRA on the attention
    # projections by their diffusers names, bf16 base, every block
    # checkpointed, graphed; the default ltx_i2v_prob takes the per-frame path
    out = os.path.join(work, "ltx_train")
    cache = os.path.join(work, "ltx_cache")
    config = _video_config("ltxvideo", ltx_dir, data, cache, out, LTX_FRAMES, LTX_TRAIN_STEPS, alignment=32,
                           lora_target_modules=["to_q", "to_k", "to_v", "to_out.0"])
    for kernel in kernels:
        kernel.launches = 0
        kernel.shape_launches.clear()
    timestep_shapes = []  # the DiT's timesteps at each eager call (the warm-up steps and the capture)
    forward = LTXTransformer.forward

    def recording(self, latents, timesteps, context):
        timestep_shapes.append(tuple(timesteps.shape))
        return forward(self, latents, timesteps, context)

    trainer = Trainer(config=config, device="cuda")
    LTXTransformer.forward = recording
    try:
        run_start = time.time()
        trainer.run()
        torch.cuda.synchronize()
        run_s = time.time() - run_start
    finally:
        LTXTransformer.forward = forward
    train_launches = {kernel.name: kernel.launches for kernel in kernels}
    shape_launches = _per_shape(kernels, 3)  # two warm-up steps and the capture
    with open(os.path.join(out, "simpletuner-tpu-metrics.jsonl")) as handle:
        metrics = [json.loads(line) for line in handle]
    losses = [m["loss"] for m in metrics]
    if [m["step"] for m in metrics] != list(range(1, LTX_TRAIN_STEPS + 1)) or not all(np.isfinite(losses)) or \
            not all(m["grad_norm"] > 0 for m in metrics) or not all(train_launches.values()):
        raise RuntimeError(f"ltx trainer: metrics {metrics}, launches {train_launches}")
    if not timestep_shapes or set(timestep_shapes) != {(1, LTX_LATENT[0])}:
        raise RuntimeError(f"ltx trainer: the DiT took timesteps of shapes {sorted(set(timestep_shapes))}, not the "
                           f"per-frame (1, {LTX_LATENT[0]})")
    bundle = trainer.data_plane.bundles["clips"]
    bucket_keys = sorted(bundle.metadata_backend.aspect_ratio_bucket_indices)
    clips = bundle.metadata_backend.aspect_ratio_bucket_indices.get(f"1.5x{LTX_FRAMES}", [])
    vae_config = model.video_vae_config()
    if len(trainer._graphs) != 1 or trainer.model.arch != arch or bucket_keys != [f"1.5x{LTX_FRAMES}"] or \
            len(clips) != LTX_CLIPS or not isinstance(trainer.vae, VideoAutoencoderKL) or \
            trainer.vae.config != vae_config or (vae_config.spatial_factor, vae_config.temporal_factor) != (32, 8):
        raise RuntimeError(f"ltx trainer: {len(trainer._graphs)} graphs, arch {trainer.model.arch}, buckets "
                           f"{bucket_keys}, VAE {type(trainer.vae).__name__} {trainer.vae.config}")
    cached = [bundle.vae_cache.load(p) for p in clips]
    if any(c.shape != LTX_LATENT + (128,) or not np.isfinite(c).all() for c in cached):
        raise RuntimeError(f"ltx trainer: cached latents {[c.shape for c in cached]}, expected {LTX_LATENT}")
    adapted = {name.rsplit("/", 2)[-2] for name in trainer._state.trainable}
    if adapted != {f"{a}_{p}" for a in ("attn1", "attn2") for p in ("q", "k", "v", "proj")}:
        raise RuntimeError(f"ltx trainer: adapters on {adapted}")
    captures = {c["step"] for c in trainer.capture_report}
    step_s = {m["step"]: m["time"] - prev["time"] for prev, m in zip(metrics, metrics[1:]) if m["step"] not in captures}
    median_s = float(np.median(list(step_s.values())))
    graphed = next(iter(trainer._graphs.values()))
    captured = {counter.name: count for counter, count in graphed.captured_launches.items()}
    profile = replay_launches(lambda: graphed(trainer._state, graphed.batch, trainer._generator), captured,
                              {kernel.name: kernel.name for kernel in kernels})
    recorded = profile["bucket_launches"]
    replayed = {kernel.name: recorded[kernel.name] for kernel in kernels}
    # every attention's forward, its recompute under remat, and its backward: two attentions a block
    per_forward = 2 * arch.depth
    expected_launches = {"flash_fwd": 2 * per_forward, "flash_bwd_dq": per_forward, "flash_bwd_dkv": per_forward}
    self_key, cross_key = f"32x{LTX_TOKENS}x{LTX_TOKENS}x64", f"32x{LTX_TOKENS}x{LTX_TEXT}x64"
    if replayed != {k: captured[k] for k in replayed} or replayed != expected_launches or \
            {k: 3 * v for k, v in replayed.items()} != train_launches or \
            any(set(shape_launches[k]) != {self_key, cross_key} or shape_launches[k][self_key] !=
                shape_launches[k][cross_key] for k in replayed):
        raise RuntimeError(f"ltx trainer: the profiled replay launched {replayed}, the capture recorded {captured}, "
                           f"the run {train_launches} ({shape_launches}), expected {expected_launches} a step")
    flops = ltx_step_flops(arch, 1, LTX_TOKENS, LTX_TEXT, LTX_LATENT[0])
    stages, startup = trainer.stage_report, trainer.data_plane.startup_metrics
    train = {"base": "bf16", "remat": "every block", "lora_rank": 16, "lora_targets": sorted(adapted),
             "lora_params": sum(p.numel() for p in trainer._state.trainable.values()),
             "ltx_i2v_prob": getattr(trainer.model.config, "ltx_i2v_prob", None), "timesteps": list(timestep_shapes[0]),
             "buckets": bucket_keys, "latents": list(cached[0].shape),
             "cache": {"text_s": startup.get("text_cache_clips_s"), "vae_s": startup.get("vae_cache_clips_s"),
                       "vae_s_per_clip": startup.get("vae_cache_clips_s", 0.0) / LTX_CLIPS,
                       "init_data_backend_peak_gib": stages["init_data_backend"]["peak_gib"]},
             "losses": losses, "grad_norms": [m["grad_norm"] for m in metrics], "step_s": step_s,
             "s_per_step_median": median_s, "flops_per_step": flops, "flop_checks": flop_checks,
             "mfu": flops / median_s / PEAK_BF16_FLOPS, "run_s": run_s,
             "time_to_first_step_s": metrics[0]["time"] - run_start,
             "capture_s": [c["seconds"] for c in trainer.capture_report],
             "stage_s": {k: v["seconds"] for k, v in stages.items()},
             "peak_gib": max(v["peak_gib"] for v in stages.values()),
             "launches_run": train_launches, "launches_captured": captured, "launches_profiled_replay": replayed,
             "launches_per_step_by_shape": shape_launches, "flash_instances": profile["flash_instances"],
             "profile": {k: profile[k] for k in ("bucket_ms", "bucket_launches", "launch_attempts", "device_ms", "traced_event_ms",
                                                 "idle_share_traced", "top_kernels")}}
    text_payload = bundle.text_cache.get(TRAIN_CAPTIONS[0])
    del trainer, graphed, bundle
    gc.collect()
    torch.cuda.empty_cache()

    # (e) a true-CFG flow Euler render at 512 px square and 121 frames through
    # the checkpoint runtime, written as mp4 and read back
    render, runtime = _video_render(work, "ltxvideo", ltx_dir, "ltx", kernels, LTX_PROMPT, LTX_GUIDANCE,
                                    LTX_RENDER_SIZE, LTX_FRAMES, per_forward)
    module, model = runtime.module, runtime.model
    if model.arch != arch or model.NAME != "ltxvideo" or not model.is_flow:
        raise RuntimeError(f"ltx: the runtime built {model.NAME} {model.arch}")
    render_latent = (LTX_LATENT[0], LTX_RENDER_SIZE // 32, LTX_RENDER_SIZE // 32)
    render_tokens = math.prod(render_latent)
    if set(render["launches_by_shape"]["flash_fwd"]) != {f"32x{render_tokens}x{render_tokens}x64",
                                                          f"32x{render_tokens}x{LTX_TEXT}x64"}:
        raise RuntimeError(f"ltx render: launches by shape {render['launches_by_shape']}")
    render.update(latents=list(render_latent), tokens=render_tokens)

    # (f) one full-depth forward, the kernels against the plain attention, on
    # the training clip's latent grid (6,144 tokens: the plain scores fit)
    batch = {"latents": torch.zeros((1,) + LTX_LATENT + (128,), device=dev)}
    for key, value in model.collate_text_embeds(model.encode_text([LTX_PROMPT])).items():
        batch[key] = torch.as_tensor(value, device=dev)
    if tuple(batch["text_embeds"].shape) != (1, LTX_TEXT, arch.text_dim):
        raise RuntimeError(f"ltx: text_embeds {tuple(batch['text_embeds'].shape)}, expected "
                           f"(1, {LTX_TEXT}, {arch.text_dim})")
    model.text_encoders = []  # the plain attention's scores need the room
    gc.collect()
    torch.cuda.empty_cache()
    cond = model.inference_conditioning(batch)
    noise = torch.randn((1,) + LTX_LATENT + (128,), generator=gen, device=dev)
    sigma = torch.tensor(LTX_SIGMA)
    with torch.no_grad():
        kernel_v = model.denoise_fn(module, cond)(noise, sigma)
        set_attention_backend("xla")
        try:
            plain_v = model.denoise_fn(module, cond)(noise, sigma)
        finally:
            set_attention_backend("auto")
        forward_ms = cuda_ms(lambda: model.denoise_fn(module, cond)(noise, sigma), 3, warmup=1)
    parity = rel_l2(kernel_v, plain_v)
    if not (torch.isfinite(kernel_v).all() and torch.isfinite(plain_v).all() and parity <= PARITY_REL_L2):
        raise RuntimeError(f"ltx full-depth parity: rel L2 {parity} (<= {PARITY_REL_L2})")
    del runtime, module, model, kernel_v, plain_v, batch, cond
    gc.collect()
    torch.cuda.empty_cache()

    # (g) the 13B width (13b-0.9.7: 4096 wide, 32 heads of 128, cross 4096)
    # at LTX13B_BLOCKS of its 48 blocks, built in memory from seeded weights:
    # an int8 base (quantized_matmul full), every block checkpointed, rank 16
    # on the attention projections, one graphed step on the first clip's
    # cached latents and its caption's T5 features, on the per-frame path
    values = {"model_family": "ltxvideo", "model_flavour": "13b-0.9.7", "model_type": "lora", "lora_rank": 16,
              "lora_target_modules": ["to_q", "to_k", "to_v", "to_out.0"], "base_model_precision": "int8-quanto",
              "quantized_matmul": "full", "gradient_checkpointing": True, "optimizer": "adamw", "learning_rate": 1e-4,
              "lr_scheduler": "constant", "max_train_steps": 10, "mixed_precision": "bf16"}
    cfg13 = config_namespace(values)
    arch13 = dataclasses.replace(LTXConfig.b13(), depth=LTX13B_BLOCKS)
    model13 = LTXVideo(cfg13, arch=arch13)
    if dataclasses.replace(LTXVideo(config_namespace(values)).arch, depth=LTX13B_BLOCKS) != arch13 or \
            (arch13.hidden_size, arch13.num_heads, arch13.head_dim, arch13.cross_dim) != (4096, 32, 128, 4096):
        raise RuntimeError(f"ltx 13B: the 13b-0.9.7 flavour builds {LTXVideo(config_namespace(values)).arch}")
    torch.cuda.reset_peak_memory_stats()
    with torch.device(dev):
        module13 = init_parameters(model13.create_module(), gen)
    params13 = sum(p.numel() for p in module13.parameters())
    batch = {"latents": torch.as_tensor(cached[0], device=dev)[None],
             "text_embeds": torch.as_tensor(text_payload["text_embeds"], device=dev)[None]}
    step13 = _graphed_step(model13, module13, batch, kernels)
    captured13, shapes13 = step13["launches_captured"], step13["launches_per_step_by_shape"]
    per_forward13 = 2 * LTX13B_BLOCKS
    key13 = f"32x{LTX_TOKENS}x{LTX_TOKENS}x128"
    if {k.name: captured13[k.name] for k in kernels} != {"flash_fwd": 2 * per_forward13,
                                                         "flash_bwd_dq": per_forward13,
                                                         "flash_bwd_dkv": per_forward13} or \
            not (np.isfinite(step13["loss"]) and step13["grad_norm"] > 0) or \
            any(shapes13[k.name].get(key13) != captured13[k.name] // 2 for k in kernels):
        raise RuntimeError(f"ltx 13B: captured {captured13} ({shapes13}), loss {step13['loss']}, grad norm "
                           f"{step13['grad_norm']}")
    flops13 = ltx_step_flops(arch13, 1, LTX_TOKENS, LTX_TEXT, LTX_LATENT[0])
    b13 = {"flavour": "13b-0.9.7", "blocks": [LTX13B_BLOCKS, 48], "hidden": arch13.hidden_size,
           "heads": [arch13.num_heads, arch13.head_dim], "params": params13, "base": "int8",
           "quantized_matmul": "full", "flops_per_step": flops13,
           "mfu": flops13 / step13["s_per_step"] / PEAK_BF16_FLOPS, **step13}
    del module13, model13, batch
    gc.collect()
    torch.cuda.empty_cache()
    phase("24 ltx", config="Lightricks/LTX-Video-0.9.5 as the JAX preset LTXConfig() builds it", params=params,
          hidden=arch.hidden_size, heads=[arch.num_heads, arch.head_dim], blocks=arch.depth,
          ffn_hidden=arch.ffn_hidden, clip=[LTX_FRAMES, LTX_HEIGHT, LTX_WIDTH], latents=list(LTX_LATENT),
          tokens={"video": LTX_TOKENS, "text": LTX_TEXT}, files=files, imported=imported, train=train,
          render=render, parity={"rel_l2": parity, "bound": PARITY_REL_L2, "sigma": LTX_SIGMA,
                                 "tokens": LTX_TOKENS, "forward_ms": forward_ms},
          b13=b13, depth_cut=f"13b-0.9.7 at {LTX13B_BLOCKS} of its 48 blocks", depth=[arch.depth, 28],
          allocated_gib_before_phase=baseline_gib, seconds=time.perf_counter() - start, device=device)
    return {"ltx_self": {k: v.get(self_key) for k, v in shape_launches.items()},
            "ltx_cross": {k: v.get(cross_key) for k, v in shape_launches.items()},
            "ltx13b_self": {k: v.get(key13) for k, v in shapes13.items()}}


def chroma_step_flops(arch, batch: int, img_tokens: int, txt_tokens: int) -> int:
    """Model FLOPs of one Chroma train step in bench.py's convention (forward
    x 3; remat recompute is hardware work, not model work), counted from the
    config: ``flux_step_flops``' blocks, embedders and head (Flux's formula,
    which counts no modulation linear) and the approximator over its
    ``mod_len`` slots per sample."""
    h, mlp, ha = arch.hidden_size, int(arch.hidden_size * arch.mlp_ratio), arch.approximator_hidden
    s = img_tokens + txt_tokens
    blocks = arch.depth_double + arch.depth_single
    fwd = s * (arch.depth_double * 2 * h * (4 * h + 2 * mlp) + arch.depth_single * (2 * h * (3 * h + mlp) +
                                                                                   2 * (h + mlp) * h))
    fwd += blocks * 4 * s * s * h + 4 * img_tokens * arch.in_channels * h + 2 * txt_tokens * arch.txt_in_features * h
    fwd += arch.mod_len * (2 * arch.approximator_channels * ha + 4 * arch.approximator_layers * ha * ha + 2 * ha * h)
    return batch * fwd * 3


def lumina2_step_flops(arch, batch: int, img_tokens: int, cap_tokens: int) -> int:
    """Model FLOPs of one Lumina2 train step in bench.py's convention (forward
    x 3), counted from the config: per token of each block q, k, v, out and
    the SwiGLU; each block's two attention products over its whole sequence
    at the query heads' width (the context refiners over the caption, the
    noise refiners over the image, the joint layers over both); the caption,
    patch, final and per-sample timestep and modulation linears."""
    h, td = arch.hidden_size, arch.time_dim
    q, kv = arch.num_heads * arch.head_dim, arch.num_kv_heads * arch.head_dim
    joint = img_tokens + cap_tokens
    per_token = 2 * h * (2 * q + 2 * kv) + 6 * h * arch.ffn_inner
    fwd = per_token * (arch.refiner_depth * (cap_tokens + img_tokens) + arch.depth * joint)
    fwd += 4 * q * (arch.refiner_depth * (cap_tokens ** 2 + img_tokens ** 2) + arch.depth * joint ** 2)
    fwd += 2 * cap_tokens * arch.cap_feat_dim * h + 4 * img_tokens * arch.patch_size ** 2 * arch.in_channels * h
    fwd += 2 * (256 * td + td * td) + 2 * td * 4 * h * (arch.refiner_depth + arch.depth) + 2 * td * h
    return batch * fwd * 3


def _flop_checks(step_flops, build, cases) -> list:
    """``step_flops`` / 3 against ``torch.utils.flop_counter`` on the forward
    of small configs on the CPU (f32; the attention through the plain
    version, whose two products the counter sees as bmm): equal.  ``cases``
    holds (arch, forward arguments, ``step_flops`` arguments after arch and
    batch)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from simpletuner_tpu_torch.models.layers import init_parameters

    checks = []
    for arch, args, counts in cases:
        module = init_parameters(build(arch, dtype=torch.float32), torch.Generator().manual_seed(0))
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            module(*args)
        expected = step_flops(arch, 2, *counts) // 3
        if counter.get_total_flops() != expected:
            raise RuntimeError(f"{step_flops.__name__}: {expected} forward FLOPs at {arch}, the counter "
                               f"{counter.get_total_flops()}")
        checks.append({"hidden": getattr(arch, "hidden_size", getattr(arch, "model_dim", None)), "tokens": list(counts),
                       "flops": expected})
    return checks


def _square_jpegs(work: str, name: str, count: int) -> str:
    """Hard links to phase 16's first ``count`` square JPEGs with captions, in ``work/name``."""
    data = os.path.join(work, name)
    os.makedirs(data)
    source = os.path.join(work, "vae_cache", "data")
    for i, index in enumerate(range(0, 3 * count, 3)):
        image = f"img_{index:04d}.jpg"
        os.link(os.path.join(source, image), os.path.join(data, image))
        with open(os.path.join(data, f"img_{index:04d}.txt"), "w") as handle:
            handle.write(TRAIN_CAPTIONS[i])
    return data


def _import_bitwise(model, module, root: str, weights: dict, params_from_diffusers, file_bytes: int) -> dict:
    """``load_transformer_params`` of ``root`` onto ``module``: s, GB/s, peak
    host RSS and device GiB, every tensor bitwise the written one taken to the
    module's dtype (exact for every e4m3 value), one tensor at a time (a
    20B module in bf16 and its e4m3 weights fit the card; a second bf16 copy
    would not)."""
    import torch

    from simpletuner_tpu_torch.models.weight_bridge import _checked
    from simpletuner_tpu_torch.models.weight_import import load_transformer_params

    params = sum(p.numel() for p in module.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rss_before = _rss_gib()
    t0 = time.perf_counter()
    load_transformer_params(model, module, root)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    state = module.state_dict()
    expected = _checked(params_from_diffusers(weights, model.arch), state, None, None, False)
    unequal = [k for k, v in state.items() if not torch.equal(v, expected[k].to(v.dtype))]
    if unequal or params != sum(v.numel() for v in weights.values()):
        raise RuntimeError(f"{model.NAME}: the imported module differs from the written tensors at {unequal[:8]}")
    return {"s": load_s, "gb_per_s": file_bytes / load_s / 1e9, "params": params, "tensors_bitwise": len(expected),
            "host_rss_gib": {"before": rss_before, "after": _rss_gib()},
            "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}


def _parity_forward(model, module, batch: dict, noise, sigma: float) -> dict:
    """One full-depth denoise call with the kernels against the same call
    through the plain attention (phase 5's bound), and the call's time."""
    import torch

    from simpletuner_tpu_torch.ops import set_attention_backend

    cond = model.inference_conditioning(batch)
    sigma_t = torch.tensor(sigma)
    with torch.no_grad():
        kernel_v = model.denoise_fn(module, cond)(noise, sigma_t)
        set_attention_backend("xla")
        try:
            plain_v = model.denoise_fn(module, cond)(noise, sigma_t)
        finally:
            set_attention_backend("auto")
        forward_ms = cuda_ms(lambda: model.denoise_fn(module, cond)(noise, sigma_t), 3, warmup=1)
    parity = rel_l2(kernel_v, plain_v)
    if not (torch.isfinite(kernel_v).all() and torch.isfinite(plain_v).all() and parity <= PARITY_REL_L2):
        raise RuntimeError(f"{model.NAME} full-depth parity: rel L2 {parity} (<= {PARITY_REL_L2})")
    return {"rel_l2": parity, "bound": PARITY_REL_L2, "sigma": sigma, "forward_ms": forward_ms}


def _train_graphed(config: dict, kernels, steps: int, expected: dict, flops: float, check) -> dict:
    """``Trainer.run()`` of ``config`` (one square bucket, graphed) and a
    profiled replay: losses and grad norms finite and positive, one graph, the
    replay's launches equal to the capture's and to ``expected`` (per step),
    ``check(trainer)`` for the family's own conditions; s/step (median of the
    replayed steps), MFU of ``flops``, time to the first step, peak GiB, the
    launches by shape per step (the wrappers count the two warm-up steps and
    the capture) and the replay's device ms by bucket and idle share."""
    import numpy as np
    import torch

    from simpletuner_tpu_torch.bench import replay_launches
    from simpletuner_tpu_torch.training.trainer import Trainer

    for kernel in kernels:
        kernel.launches = 0
        kernel.shape_launches.clear()
    trainer = Trainer(config=config, device="cuda")
    run_start = time.time()
    trainer.run()
    torch.cuda.synchronize()
    run_s = time.time() - run_start
    train_launches = {kernel.name: kernel.launches for kernel in kernels}
    shape_launches = _per_shape(kernels, 3)
    with open(os.path.join(config["output_dir"], "simpletuner-tpu-metrics.jsonl")) as handle:
        metrics = [json.loads(line) for line in handle]
    losses = [m["loss"] for m in metrics]
    if [m["step"] for m in metrics] != list(range(1, steps + 1)) or not all(np.isfinite(losses)) or \
            not all(m["grad_norm"] > 0 for m in metrics) or not all(train_launches.values()) or \
            len(trainer._graphs) != 1:
        raise RuntimeError(f"{config['model_family']} trainer: metrics {metrics}, launches {train_launches}, "
                           f"{len(trainer._graphs)} graphs")
    extra = check(trainer)
    captures = {c["step"] for c in trainer.capture_report}
    step_s = {m["step"]: m["time"] - prev["time"] for prev, m in zip(metrics, metrics[1:]) if m["step"] not in captures}
    median_s = float(np.median(list(step_s.values())))
    graphed = next(iter(trainer._graphs.values()))
    captured = {counter.name: count for counter, count in graphed.captured_launches.items()}
    profile = replay_launches(lambda: graphed(trainer._state, graphed.batch, trainer._generator), captured,
                              {kernel.name: kernel.name for kernel in kernels})
    replayed = {kernel.name: profile["bucket_launches"][kernel.name] for kernel in kernels}
    if replayed != {k: captured[k] for k in replayed} or replayed != expected or \
            {k: 3 * v for k, v in replayed.items()} != train_launches:
        raise RuntimeError(f"{config['model_family']} trainer: the profiled replay launched {replayed}, the capture "
                           f"recorded {captured}, the run {train_launches}, expected {expected} a step")
    stages = trainer.stage_report
    report = {"lora_params": sum(p.numel() for p in trainer._state.trainable.values()),
              "lora_targets": sorted({name.rsplit("/", 2)[-2] for name in trainer._state.trainable}),
              "losses": losses, "grad_norms": [m["grad_norm"] for m in metrics], "step_s": step_s,
              "s_per_step_median": median_s, "flops_per_step": flops, "mfu": flops / median_s / PEAK_BF16_FLOPS,
              "run_s": run_s, "time_to_first_step_s": metrics[0]["time"] - run_start,
              "capture_s": [c["seconds"] for c in trainer.capture_report],
              "stage_s": {k: v["seconds"] for k, v in stages.items()},
              "peak_gib": max(v["peak_gib"] for v in stages.values()),
              "launches_run": train_launches, "launches_captured": captured, "launches_profiled_replay": replayed,
              "launches_per_step_by_shape": shape_launches, "flash_instances": profile["flash_instances"],
              "profile": {k: profile[k] for k in ("bucket_ms", "bucket_launches", "launch_attempts", "device_ms", "traced_event_ms",
                                                  "idle_share_traced", "top_kernels")}, **extra}
    del trainer, graphed
    return report


def _render_report(timed: dict, per_forward: int, guidance: float, init_s: float) -> dict:
    """A 1024 px true-CFG render's numbers, its PNG and latents checked and
    ``per_forward`` flash launches a forward, two forwards a step."""
    rendered, forward_s = timed["rendered"], timed["forward_s"]
    if timed["launches"] != {"flash_fwd": per_forward * 2 * STEPS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0} or \
            len(rendered) != 1 or timed["finite"] != [True] or len(forward_s) != 2 * STEPS:
        raise RuntimeError(f"render: {rendered}, finite latents {timed['finite']}, {len(forward_s)} forwards, "
                           f"launches {timed['launches']}, expected {per_forward} per forward, two a step")
    check_png(rendered[0], RESOLUTION, RESOLUTION)
    return {"init_s": init_s, "render_s": timed["render_s"], "steps": STEPS, "guidance": guidance,
            "s_per_cfg_step": sum(forward_s[2:]) / (len(forward_s) - 2) * 2, "forward_s": forward_s,
            "vae_decode_s": timed["decode_s"][0], "peak_gib": timed["peak_gib"], "launches": timed["launches"],
            "launches_per_cfg_step": {k: v // STEPS for k, v in timed["launches"].items()},
            "launches_by_shape": timed["launches_by_shape"], "png": os.path.basename(rendered[0]),
            "png_bytes": os.path.getsize(rendered[0])}


def chroma_phase(paths: dict, kernels, device: str, depth: tuple) -> dict:
    """Phase 25: Chroma at its published width and ``depth`` (double,
    single) blocks: a seeded e4m3 diffusers
    transformer (two shards) written with the port's writer beside hard links
    to phase 14's Flux VAE and phase 15's T5-XXL (``text_encoder``) and T5
    tokenizer (``tokenizer_2``, the subfolder both packages' T5 spec reads);
    the import held bitwise to the written tensors; a 1024 px true-CFG flow
    Euler render through ``CheckpointInferenceRuntime``; one full-depth
    forward with the kernels against the plain attention, the T5 mask
    collated as the trainer collates it; 6 graphed LoRA steps through
    ``Trainer.run()`` on an int8 base (``quantized_matmul: full``), every
    block checkpointed, and the launches of a profiled replay held to the
    capture's.  Returns the replay's launches per kernel."""
    import gc

    import torch

    from simpletuner_tpu_torch.inference import CheckpointInferenceRuntime, config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import chroma_checkpoint_shapes
    from simpletuner_tpu_torch.models.chroma import ChromaConfig, ChromaTransformer
    from simpletuner_tpu_torch.models.flux import make_img_ids, make_txt_ids
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.vae import VAEConfig
    from simpletuner_tpu_torch.models.weight_import import chroma_params_from_diffusers

    start = time.perf_counter()
    work, flux_dir = paths["work"], paths["flux_dir"]
    for out in ("ltx", "ltx_train", "ltx_cache", "ltx_render") + (() if _runs(46) else ("ltx_data",)):
        shutil.rmtree(os.path.join(work, out), ignore_errors=True)  # phase 24's: disk space; phase 46 links its clips
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    tiny = ChromaConfig.tiny()
    wider = dataclasses.replace(tiny, hidden_size=96, num_heads=3, depth_single=1, approximator_layers=3,
                                approximator_hidden=80)
    flop_checks = _flop_checks(chroma_step_flops, ChromaTransformer, [
        (arch, (torch.zeros(2, (h // 2) * (w // 2), arch.in_channels), make_img_ids(2, h, w),
                torch.zeros(2, t, arch.txt_in_features), make_txt_ids(2, t), torch.full((2,), 0.5)),
         ((h // 2) * (w // 2), t)) for arch, (h, w), t in ((tiny, (8, 6), 7), (wider, (4, 8), 5))])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(25)
    full = ChromaConfig()
    if (full.hidden_size, full.depth_double, full.depth_single, full.num_heads, full.head_dim, full.mod_len,
            full.approximator_hidden) != (3072, 19, 38, 24, 128, 344, 5120):
        raise RuntimeError(f"not Chroma's published transformer: {full}")
    arch = dataclasses.replace(full, depth_double=depth[0], depth_single=depth[1])
    shapes = chroma_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 6e9 or written_before + file_bytes / 1e9 + 0.15 + _reserved(25) > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"chroma: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the phase; "
                           f"it and the later phases write {file_bytes / 1e9 + 0.15 + _reserved(25):.1f} GB of the "
                           f"{RUN_WRITE_TARGET_GB} GB a run may write")

    # (b) the seeded files: the transformer (two e4m3 shards), hard links to
    # phase 14's Flux VAE and phase 15's T5-XXL and T5 tokenizer
    chroma_dir = os.path.join(work, "chroma")
    weights, write_s = _write_e4m3_transformer(chroma_dir, shapes, gen)
    for source, target in (("text_encoder_2", "text_encoder"), ("tokenizer_2", "tokenizer_2"), ("vae", "vae")):
        _link_tree(os.path.join(flux_dir, source), os.path.join(chroma_dir, target))
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "written_gb_before": written_before,
             "written_gb_after": _written_gb(), "free_gb_before": free / 1e9}

    # (c) the import, bitwise
    model = ModelRegistry.create("chroma", config_namespace({"model_family": "chroma", "model_type": "full"}))
    if model.arch != arch:
        raise RuntimeError(f"chroma: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()  # model_type full: no adapters
    imported = _import_bitwise(model, module, chroma_dir, weights, chroma_params_from_diffusers, file_bytes)
    params = imported["params"]
    del weights, module
    gc.collect()
    torch.cuda.empty_cache()

    # (d) a 1024x1024 true-CFG flow Euler render through the checkpoint
    # runtime (unmasked, as Flux's validation renders); (e) one full-depth
    # forward, the kernels against the plain attention, the T5 mask collated
    # as the trainer collates it
    config_path = os.path.join(work, "chroma_render.json")
    with open(config_path, "w") as handle:
        json.dump({"model_family": "chroma", "model_type": "full", "pretrained_model_name_or_path": chroma_dir,
                   "mixed_precision": "bf16", "text_encoder_precision": "bf16", "vae_dtype": "bf16",
                   "validation_resolution": RESOLUTION, "validation_seed": 42, "seed": 42,
                   "validation_guidance": CHROMA_GUIDANCE, "flux_attention_masked_training": True}, handle)
    t0 = time.perf_counter()
    runtime = CheckpointInferenceRuntime(config_path=config_path, output=os.path.join(work, "chroma_render"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    module, model = runtime.module, runtime.model
    if model.arch != arch or model.NAME != "chroma" or not model.is_flow:
        raise RuntimeError(f"chroma: the runtime built {model.NAME} {model.arch}")
    per_forward = arch.depth_double + arch.depth_single
    render = _render_report(_timed_render(runtime, kernels, CHROMA_PROMPT, CHROMA_GUIDANCE), per_forward,
                            CHROMA_GUIDANCE, init_s)
    latent = RESOLUTION // 8
    batch = {"latents": torch.zeros((1, latent, latent, 16), device=dev)}
    embeds = model.encode_text([CHROMA_PROMPT])
    for key, value in model.collate_text_embeds(embeds).items():
        batch[key] = torch.as_tensor(value, device=dev)
    if tuple(batch["t5_embeds"].shape) != (1, TXT_LEN, arch.txt_in_features) or batch["pooled_embeds"].any():
        raise RuntimeError(f"chroma: t5_embeds {tuple(batch['t5_embeds'].shape)}, pooled all zero "
                           f"{not batch['pooled_embeds'].any()}")
    model.text_encoders = []  # the plain attention's scores need the room
    gc.collect()
    torch.cuda.empty_cache()
    noise = torch.randn((1, latent, latent, 16), generator=gen, device=dev)
    parity = {**_parity_forward(model, module, batch, noise, CHROMA_SIGMA),
              "txt_valid": int(embeds[0]["attention_mask"].sum())}
    del runtime, module, model, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (f) Trainer.run(): int8 base with quantized_matmul=full, every block
    # checkpointed (the JAX module's nn.remat, no Flux policy), rank-16 LoRA on
    # Flux's `all` targets, the T5 padding masked, one square bucket, graphed
    data = _square_jpegs(work, "chroma_data", CHROMA_TRAIN_IMAGES)
    cache = os.path.join(work, "chroma_cache")
    config = {
        "model_family": "chroma", "model_type": "lora", "lora_rank": 16, "pretrained_model_name_or_path": chroma_dir,
        "base_model_precision": "int8-quanto", "quantized_matmul": "full", "gradient_checkpointing": True,
        "flux_attention_masked_training": True, "optimizer": "adamw", "learning_rate": 1e-4,
        "lr_scheduler": "constant", "mixed_precision": "bf16", "text_encoder_precision": "bf16", "vae_dtype": "bf16",
        "train_batch_size": 1, "resolution": RESOLUTION, "resolution_type": "pixel_area",
        "max_train_steps": CHROMA_TRAIN_STEPS, "logging_steps": 1, "report_to": "jsonl", "seed": 42,
        "cache_dir": cache, "output_dir": os.path.join(work, "chroma_train"), "checkpoint_frozen_base": "reference",
        "data_backend_config": [
            {"id": "train", "dataset_type": "image", "type": "local", "instance_data_dir": data,
             "resolution": RESOLUTION, "resolution_type": "pixel_area", "caption_strategy": "textfile",
             "cache_dir_vae": os.path.join(cache, "vae")},
            {"id": "embeds", "dataset_type": "text_embeds", "type": "local", "default": True,
             "cache_dir": os.path.join(cache, "text")},
        ],
    }

    def check(trainer) -> dict:
        if trainer.model.arch != arch or trainer.vae.config != VAEConfig.flux() or \
                trainer.model.base_precision != "int8":
            raise RuntimeError(f"chroma trainer: arch {trainer.model.arch}, VAE {trainer.vae.config}, base "
                               f"{trainer.model.base_precision}")
        return {}

    # every attention's forward and its recompute under remat, and its backward
    expected = {"flash_fwd": 2 * per_forward, "flash_bwd_dq": per_forward, "flash_bwd_dkv": per_forward}
    flops = chroma_step_flops(arch, 1, (latent // 2) ** 2, TXT_LEN)
    train = _train_graphed(config, kernels, CHROMA_TRAIN_STEPS, expected, flops, check)
    train.update({"base": "int8", "quantized_matmul": "full", "remat": "every block", "lora_rank": 16,
                  "flop_checks": flop_checks})
    phase("25 chroma", config="lodestones/Chroma transformer (ChromaConfig())", params=params,
          hidden=arch.hidden_size, heads=[arch.num_heads, arch.head_dim], blocks=[arch.depth_double, arch.depth_single],
          depth=[[arch.depth_double, arch.depth_single], [full.depth_double, full.depth_single]], mod_len=arch.mod_len,
          approximator=[arch.approximator_layers, arch.approximator_hidden],
          tokens={"text": TXT_LEN, "image": (latent // 2) ** 2}, files=files, imported=imported, render=render,
          parity=parity, train=train, allocated_gib_before_phase=baseline_gib,
          seconds=time.perf_counter() - start, device=device)
    gc.collect()
    torch.cuda.empty_cache()
    return train["launches_profiled_replay"]


def write_gemma_tokenizer(root: str, words) -> None:
    """A tokenizer in ``root`` in Gemma's convention (``<pad>`` 0, ``<eos>`` 1,
    ``<bos>`` 2 prepended, padding on the right) that ``AutoTokenizer``
    reads: a word-level ``tokenizer.json`` over ``words`` and single
    characters, and a ``tokenizer_config.json``."""
    import string

    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, processors

    vocab = {"<pad>": 0, "<eos>": 1, "<bos>": 2, "<unk>": 3}
    for word in sorted({w.lower().strip(",.") for w in words} | set(string.ascii_lowercase + string.digits)):
        vocab.setdefault(word, len(vocab))
    tokenizer = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tokenizer.normalizer = normalizers.Lowercase()
    tokenizer.pre_tokenizer = pre_tokenizers.Whitespace()
    tokenizer.post_processor = processors.TemplateProcessing(single="<bos> $A", special_tokens=[("<bos>", 2)])
    os.makedirs(root, exist_ok=True)
    tokenizer.save(os.path.join(root, "tokenizer.json"))
    with open(os.path.join(root, "tokenizer_config.json"), "w") as handle:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "model_max_length": 8192, "pad_token": "<pad>",
                   "eos_token": "<eos>", "bos_token": "<bos>", "unk_token": "<unk>", "padding_side": "right"}, handle)


def lumina2_phase(paths: dict, kernels, device: str, depth: int) -> dict:
    """Phase 26: Lumina-Image 2.0 at the JAX preset's published width and
    ``depth`` of its 26 joint blocks with its
    Gemma-2 2B text encoder: a seeded e4m3 diffusers transformer, a seeded
    Gemma-2 2B in the HF layout (e4m3, full width; ``GEMMA_FILE_LAYERS`` of
    its 26 layers, the full depth in a run that names phase 26 where its
    writes leave room) with its
    ``config.json``, a seeded tokenizer in ``tokenizer/`` and a hard link to
    phase 14's Flux VAE; 256-token prompts through ``LLMTextEncoder``
    (prompts/s, bf16 against the f32 module); the import held bitwise; a
    1024 px true-CFG flow Euler render; one full-depth forward with the D =
    96 kernels against the plain attention, the caption mask on; 6 graphed
    LoRA steps through ``Trainer.run()`` on a bf16 base, every block
    checkpointed, and the launches of a profiled replay held to the
    capture's, by shape.  Returns the launches per step of each kernel at
    each Lumina2 shape."""
    import gc

    import torch

    from simpletuner_tpu_torch.inference import CheckpointInferenceRuntime, config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import llm_checkpoint_shapes, lumina2_checkpoint_shapes
    from simpletuner_tpu_torch.models.llm_encoder import LLMEncoderConfig
    from simpletuner_tpu_torch.models.lumina2 import Lumina2, Lumina2Config, Lumina2Transformer
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.vae import VAEConfig
    from simpletuner_tpu_torch.models.weight_import import lumina2_params_from_diffusers, save_safetensors

    start = time.perf_counter()
    work, flux_dir = paths["work"], paths["flux_dir"]
    for out in ("chroma", "chroma_train", "chroma_cache", "chroma_data", "chroma_render"):  # disk space
        shutil.rmtree(os.path.join(work, out), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    tiny = Lumina2Config.tiny()
    wider = dataclasses.replace(tiny, hidden_size=64, num_heads=4, num_kv_heads=1, refiner_depth=2, depth=1,
                                cap_feat_dim=24, axes_dim=(4, 6, 6))
    flop_checks = _flop_checks(lumina2_step_flops, Lumina2Transformer, [
        (arch, (torch.zeros(2, h, w, arch.in_channels), torch.full((2,), 0.5), torch.zeros(2, t, arch.cap_feat_dim),
                torch.ones(2, t, dtype=torch.int32)), ((h // 2) * (w // 2), t))
        for arch, (h, w), t in ((tiny, (8, 6), 7), (wider, (4, 8), 5))])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    full = Lumina2Config()
    if (full.hidden_size, full.depth, full.refiner_depth, full.num_heads, full.num_kv_heads, full.head_dim,
            full.ffn_inner) != (2304, 26, 2, 24, 8, 96, 6144):
        raise RuntimeError(f"not Lumina-Image 2.0's published transformer: {full}")
    arch = dataclasses.replace(full, depth=depth)
    gemma_full = LLMEncoderConfig.gemma2_2b()
    shapes = lumina2_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each

    def gemma_bytes(layers: int) -> int:
        return sum(math.prod(s) for s in llm_checkpoint_shapes(dataclasses.replace(gemma_full, num_layers=layers))
                   .values())

    written_before, free = _written_gb(), shutil.disk_usage(work).free
    # GEMMA_FILE_LAYERS in a run of every phase; full depth in a run that
    # names phase 26 where its writes leave room beside the later phases'
    room = RUN_WRITE_TARGET_GB - written_before - file_bytes / 1e9 - 0.2 - _reserved(26)
    layers = gemma_full.num_layers if _full_depth(26, (gemma_bytes(gemma_full.num_layers) - gemma_bytes(
        GEMMA_FILE_LAYERS)) / 1e9) else GEMMA_FILE_LAYERS
    gemma = dataclasses.replace(gemma_full, num_layers=layers)
    if free < file_bytes + 8e9 or gemma_bytes(layers) / 1e9 > room:
        raise RuntimeError(f"lumina2: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the phase; "
                           f"its files need {(file_bytes + gemma_bytes(layers)) / 1e9 + 0.2:.1f} GB of the "
                           f"{RUN_WRITE_TARGET_GB} GB a run may write")

    # (b) the seeded files: the transformer (two e4m3 shards), Gemma-2 in the
    # HF layout (one e4m3 file; matrices N(0, 1/fan_in), the embedding N(0,
    # 1/2304), the unit-offset norm scales N(0, 0.1)) with its config.json,
    # the tokenizer, and a hard link to phase 14's Flux VAE
    lumina_dir = os.path.join(work, "lumina2")
    weights, write_s = _write_e4m3_transformer(lumina_dir, shapes, gen)
    gemma_shapes = llm_checkpoint_shapes(gemma)
    gemma_weights = {}
    for name, shape in gemma_shapes.items():
        draw = torch.randn(shape, generator=gen, device=dev)
        draw = 0.1 * draw if len(shape) == 1 else draw / math.sqrt(shape[-1])
        gemma_weights[name] = draw.to(torch.float8_e4m3fn)
    os.makedirs(os.path.join(lumina_dir, "text_encoder"))
    t0 = time.perf_counter()
    save_safetensors(gemma_weights, os.path.join(lumina_dir, "text_encoder", "model.safetensors"))
    gemma_write_s = time.perf_counter() - t0
    del gemma_weights
    with open(os.path.join(lumina_dir, "text_encoder", "config.json"), "w") as handle:
        json.dump({"architectures": ["Gemma2Model"], "model_type": "gemma2", "vocab_size": gemma.vocab_size,
                   "hidden_size": gemma.hidden_size, "intermediate_size": gemma.intermediate_size,
                   "num_hidden_layers": layers, "num_attention_heads": gemma.num_heads,
                   "num_key_value_heads": gemma.num_kv_heads, "head_dim": gemma.head_dim,
                   "rope_theta": gemma.rope_theta, "rms_norm_eps": gemma.rms_eps, "query_pre_attn_scalar": 256,
                   "attn_logit_softcapping": 50.0, "hidden_activation": "gelu_pytorch_tanh",
                   "torch_dtype": "float8_e4m3fn"}, handle)
    write_gemma_tokenizer(os.path.join(lumina_dir, "tokenizer"),
                          " ".join(TRAIN_CAPTIONS + [LUMINA_PROMPT]).split())
    _link_tree(os.path.join(flux_dir, "vae"), os.path.join(lumina_dir, "vae"))
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "gemma_gb": gemma_bytes(layers) / 1e9,
             "gemma_dtype": "float8_e4m3fn", "gemma_layers": [layers, gemma_full.num_layers],
             "gemma_write_s": gemma_write_s, "written_gb_before": written_before, "written_gb_after": _written_gb(),
             "free_gb_before": free / 1e9}

    # (c) text encoding: prompts at 256 tokens through the builder the
    # trainer uses (bf16 compute), prompts/s, and bf16 against the f32 module
    # on the same weights and tokens
    prompts = [f"{TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]} number {i}" for i in range(TEXT_PROMPTS)]
    text = {**_llm_text_report(Lumina2.TEXT_ENCODER_CONFIGURATION[0], lumina_dir, gemma, LUMINA_CAP, prompts),
            "layers": [layers, gemma_full.num_layers]}

    # (d) the import, bitwise
    model = ModelRegistry.create("lumina2", config_namespace({"model_family": "lumina2", "model_type": "full"}))
    if model.arch != arch:
        raise RuntimeError(f"lumina2: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()
    imported = _import_bitwise(model, module, lumina_dir, weights, lumina2_params_from_diffusers, file_bytes)
    params = imported["params"]
    del weights, module
    gc.collect()
    torch.cuda.empty_cache()

    # (e) a 1024x1024 true-CFG flow Euler render (the caption mask rides the
    # conditioning); (f) one full-depth forward, kernels against the plain attention
    config_path = os.path.join(work, "lumina2_render.json")
    with open(config_path, "w") as handle:
        json.dump({"model_family": "lumina2", "model_type": "full", "pretrained_model_name_or_path": lumina_dir,
                   "mixed_precision": "bf16", "vae_dtype": "bf16", "validation_resolution": RESOLUTION,
                   "validation_seed": 42, "seed": 42, "validation_guidance": LUMINA_GUIDANCE}, handle)
    t0 = time.perf_counter()
    runtime = CheckpointInferenceRuntime(config_path=config_path, output=os.path.join(work, "lumina2_render"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    module, model = runtime.module, runtime.model
    if model.arch != arch or model.NAME != "lumina2" or not model.is_flow:
        raise RuntimeError(f"lumina2: the runtime built {model.NAME} {model.arch}")
    per_forward = 2 * arch.refiner_depth + arch.depth
    timed = _timed_render(runtime, kernels, LUMINA_PROMPT, LUMINA_GUIDANCE)
    render = _render_report(timed, per_forward, LUMINA_GUIDANCE, init_s)
    keys = {name: f"24x{sq}x{sk}x96" for name, _, sq, sk, *_ in LUMINA_KERNEL_CASES}
    per_shape = {"lumina_joint": arch.depth, "lumina_noise_refiner": arch.refiner_depth,
                 "lumina_context_refiner": arch.refiner_depth}
    if timed["launches_by_shape"]["flash_fwd"] != {keys[n]: 2 * STEPS * c for n, c in per_shape.items()}:
        raise RuntimeError(f"lumina2 render: launches by shape {timed['launches_by_shape']}")
    latent = RESOLUTION // 8
    batch = {"latents": torch.zeros((1, latent, latent, 16), device=dev)}
    embeds = model.encode_text([LUMINA_PROMPT])
    for key, value in model.collate_text_embeds(embeds).items():
        batch[key] = torch.as_tensor(value, device=dev)
    if tuple(batch["text_embeds"].shape) != (1, LUMINA_CAP, arch.cap_feat_dim) or \
            not 1 < int(batch["text_attention_mask"].sum()) < LUMINA_CAP:
        raise RuntimeError(f"lumina2: text_embeds {tuple(batch['text_embeds'].shape)}, mask "
                           f"{int(batch['text_attention_mask'].sum())} valid")
    model.text_encoders = []
    gc.collect()
    torch.cuda.empty_cache()
    noise = torch.randn((1, latent, latent, 16), generator=gen, device=dev)
    parity = {**_parity_forward(model, module, batch, noise, LUMINA_SIGMA),
              "caption_valid": int(batch["text_attention_mask"].sum())}
    del runtime, module, model, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (g) Trainer.run(): bf16 base, every block checkpointed, rank-16 LoRA on
    # the attention projections by their diffusers names, one square bucket
    data = _square_jpegs(work, "lumina2_data", LUMINA_TRAIN_IMAGES)
    cache = os.path.join(work, "lumina2_cache")
    config = {
        "model_family": "lumina2", "model_type": "lora", "lora_rank": 16,
        "lora_target_modules": ["to_q", "to_k", "to_v", "to_out.0"], "pretrained_model_name_or_path": lumina_dir,
        "gradient_checkpointing": True, "optimizer": "adamw", "learning_rate": 1e-4, "lr_scheduler": "constant",
        "mixed_precision": "bf16", "vae_dtype": "bf16", "train_batch_size": 1, "resolution": RESOLUTION,
        "resolution_type": "pixel_area", "max_train_steps": LUMINA_TRAIN_STEPS, "logging_steps": 1,
        "report_to": "jsonl", "seed": 42, "cache_dir": cache, "output_dir": os.path.join(work, "lumina2_train"),
        "checkpoint_frozen_base": "reference",
        "data_backend_config": [
            {"id": "train", "dataset_type": "image", "type": "local", "instance_data_dir": data,
             "resolution": RESOLUTION, "resolution_type": "pixel_area", "caption_strategy": "textfile",
             "cache_dir_vae": os.path.join(cache, "vae")},
            {"id": "embeds", "dataset_type": "text_embeds", "type": "local", "default": True,
             "cache_dir": os.path.join(cache, "text")},
        ],
    }

    def check(trainer) -> dict:
        adapted = {name.rsplit("/", 2)[-2] for name in trainer._state.trainable}
        if trainer.model.arch != arch or trainer.vae.config != VAEConfig.flux() or \
                adapted != {"attn_q", "attn_k", "attn_v", "attn_proj"}:
            raise RuntimeError(f"lumina2 trainer: arch {trainer.model.arch}, VAE {trainer.vae.config}, adapters on "
                               f"{adapted}")
        masks = trainer._example_batch()["text_attention_mask"]
        return {"caption_valid": int(masks.sum())}

    expected = {"flash_fwd": 2 * per_forward, "flash_bwd_dq": per_forward, "flash_bwd_dkv": per_forward}
    flops = lumina2_step_flops(arch, 1, (latent // 2) ** 2, LUMINA_CAP)
    train = _train_graphed(config, kernels, LUMINA_TRAIN_STEPS, expected, flops, check)
    by_shape = train["launches_per_step_by_shape"]
    if by_shape["flash_fwd"] != {keys[n]: 2 * c for n, c in per_shape.items()} or \
            any(by_shape[k] != {keys[n]: c for n, c in per_shape.items()} for k in ("flash_bwd_dq", "flash_bwd_dkv")):
        raise RuntimeError(f"lumina2 trainer: launches per step by shape {by_shape}")
    train.update({"base": "bf16", "remat": "every block", "lora_rank": 16, "flop_checks": flop_checks})
    phase("26 lumina2", config="Alpha-VLLM/Lumina-Image-2.0 transformer/ as the JAX preset Lumina2Config() builds it",
          params=params, hidden=arch.hidden_size, heads=[arch.num_heads, arch.num_kv_heads, arch.head_dim],
          blocks=[arch.refiner_depth, arch.refiner_depth, arch.depth], depth=[arch.depth, full.depth],
          ffn_inner=arch.ffn_inner, tokens={"caption": LUMINA_CAP, "image": (latent // 2) ** 2, "joint": LUMINA_S},
          files=files, text_encoder=text, imported=imported, render=render, parity=parity, train=train,
          allocated_gib_before_phase=baseline_gib, seconds=time.perf_counter() - start, device=device)
    gc.collect()
    torch.cuda.empty_cache()
    return {name: {k: v.get(keys[name]) for k, v in by_shape.items()} for name in keys}


def kandinsky5_step_flops(arch, batch: int, tokens: int, text_tokens: int) -> int:
    """Model FLOPs of one Kandinsky 5.0 train step in bench.py's convention
    (forward x 3; remat recompute is hardware work, not model work), counted
    from the config at ``tokens`` visual and ``text_tokens`` Qwen tokens with
    per-sample timesteps: the time MLP, the pooled and text embeddings, the
    visual patch linear; per text block its modulation, q / k / v / out, the
    attention's two products and the feed-forward; per visual block its
    modulation, the self-attention (q / k / v / out and two products), the
    cross-attention (q and out per visual token, k and v per text token, two
    products) and the feed-forward; the out modulation and projection."""
    d, td, ff = arch.model_dim, arch.time_dim, arch.ff_dim
    patch = arch.patch_size[0] * arch.patch_size[1] * arch.patch_size[2]
    fwd = 2 * (d * td + td * td) + 2 * arch.in_text_dim2 * td + 2 * text_tokens * arch.in_text_dim * d
    fwd += 2 * tokens * patch * arch.visual_embed_dim * d
    text_block = 2 * td * 6 * d + 2 * text_tokens * (4 * d * d + 2 * d * ff) + 4 * text_tokens ** 2 * d
    visual_block = (2 * td * 9 * d + 2 * tokens * (4 * d * d + 2 * d * d + 2 * d * ff) + 4 * tokens ** 2 * d
                    + 2 * text_tokens * 2 * d * d + 4 * tokens * text_tokens * d)
    fwd += arch.num_text_blocks * text_block + arch.num_visual_blocks * visual_block
    fwd += 2 * td * 2 * d + 2 * tokens * d * patch * arch.out_visual_dim
    return batch * fwd * 3


def hunyuanvideo_step_flops(arch, batch: int, video_tokens: int, qwen_tokens: int, byt5_tokens: int) -> int:
    """Model FLOPs of one HunyuanVideo 1.5 train step in bench.py's
    convention (forward x 3), counted from the config: the patch linear, the
    time MLP; the token refiner (its time and pooled-text MLPs, ``proj_in``,
    per block its gates, q / k / v / out, two products and the MLP over the
    Qwen tokens); the ByT5 projection (2048, 2048, dim); per dual-stream
    block both streams' modulation, q / k / v / out and MLP and the joint
    attention's two products over every token, pads included; the head."""
    d, mlp = arch.hidden_size, int(arch.hidden_size * arch.mlp_ratio)
    text = qwen_tokens + byt5_tokens
    joint = video_tokens + text
    fwd = 2 * video_tokens * arch.in_channels * d + 2 * (256 * d + d * d)
    fwd += 2 * (256 * d + d * d) + 2 * (arch.text_dim * d + d * d) + 2 * qwen_tokens * arch.text_dim * d
    fwd += arch.refiner_depth * (2 * d * 2 * d + 2 * qwen_tokens * (4 * d * d + 2 * d * mlp) + 4 * qwen_tokens ** 2 * d)
    fwd += 2 * byt5_tokens * (arch.text2_dim * 2048 + 2048 * 2048 + 2048 * d)
    fwd += arch.depth * (2 * 2 * d * 6 * d + 2 * joint * (4 * d * d + 2 * d * mlp) + 4 * joint * joint * d)
    fwd += 2 * d * 2 * d + 2 * video_tokens * d * arch.out_channels
    return batch * fwd * 3


def write_llm_trunk(root: str, config, gen, hf_config: dict, extra: dict = None) -> float:
    """A seeded decoder-LLM trunk of ``config`` in the HF layout under
    ``root``: e4m3 tensors (matrices N(0, 1/fan_in), norm weights 1 + N(0,
    0.1), biases N(0, 0.01)) drawn on the card, ``extra`` tensors beside
    them, and a ``config.json`` of ``hf_config`` with the trunk's sizes as
    top-level keys; returns the write seconds."""
    import torch

    from simpletuner_tpu_torch.models.checkpoint_layouts import llm_checkpoint_shapes
    from simpletuner_tpu_torch.models.weight_import import save_safetensors

    weights = {}
    for name, shape in llm_checkpoint_shapes(config).items():
        draw = torch.randn(shape, generator=gen, device="cuda")
        if len(shape) > 1:
            draw = draw / math.sqrt(shape[-1])
        elif name.endswith("norm.weight") or "layernorm" in name:
            draw = 1.0 + 0.1 * draw
        else:
            draw = 0.01 * draw
        weights[name] = draw.to(torch.float8_e4m3fn)
    weights.update(extra or {})
    os.makedirs(root)
    t0 = time.perf_counter()
    save_safetensors(weights, os.path.join(root, "model.safetensors"))
    write_s = time.perf_counter() - t0
    with open(os.path.join(root, "config.json"), "w") as handle:
        json.dump({**hf_config, "vocab_size": config.vocab_size, "hidden_size": config.hidden_size,
                   "intermediate_size": config.intermediate_size, "num_hidden_layers": config.num_layers,
                   "num_attention_heads": config.num_heads, "num_key_value_heads": config.num_kv_heads,
                   "head_dim": config.head_dim, "rope_theta": config.rope_theta, "rms_norm_eps": config.rms_eps,
                   "torch_dtype": "float8_e4m3fn"}, handle)
    del weights
    torch.cuda.empty_cache()
    return write_s


# the config.json keys of a Qwen3 text trunk written in the qwen2 layout (the
# JAX specs read Qwen3 through qwen2.5 / qwen2.5-vl): Z-Image's and Krea-2's
# 2560-wide trunk (Qwen3-4B's sizes; phase 29 writes it, phases 34 and 36 link
# it) and Anima's Qwen3-0.6B (phase 38)
QWEN3_HF = {"architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3", "max_position_embeddings": 40960,
            "hidden_act": "silu", "tie_word_embeddings": True}


def zi_trunk_config():
    """The 2560-wide qwen2-layout trunk at ``ZI_TRUNK_LAYERS`` of its 36 layers."""
    from simpletuner_tpu_torch.models.llm_encoder import LLMEncoderConfig

    return LLMEncoderConfig(arch="qwen2", vocab_size=151936, hidden_size=2560, intermediate_size=9728,
                            num_layers=ZI_TRUNK_LAYERS, num_heads=32, num_kv_heads=8, head_dim=128,
                            rope_theta=1000000.0, rms_eps=1e-6, qkv_bias=True)


def qwen_trunk(paths: dict, number: int) -> dict:
    """The seeded Qwen2.5-VL-7B text trunk in the HF layout, written once a
    run (by the first of phases 27-29 that runs, ``number``) under
    ``work/qwen25_vl/text_encoder``: the ``qwen25_7b`` preset's width (3584,
    28 query / 4 kv heads of 128, FFN 18,944, 152,064 tokens, qkv biases) at
    ``QWEN_FILE_LAYERS`` of its 28 layers, or all 28 in a run that names the
    phase where its writes leave room; e4m3 (matrices N(0, 1/fan_in), norm
    weights 1 + N(0, 0.1), biases N(0, 0.01)), with one ``visual.*`` tensor
    of the published file that the importer leaves unread, and a
    ``config.json`` in Qwen/Qwen2.5-VL-7B-Instruct's layout: the text sizes
    as top-level keys beside ``vision_config`` and the mrope
    ``rope_scaling``.  The later phase hard-links it."""
    import torch

    from simpletuner_tpu_torch.models.checkpoint_layouts import llm_checkpoint_shapes
    from simpletuner_tpu_torch.models.llm_encoder import LLMEncoderConfig

    if "qwen" in paths:
        return paths["qwen"]
    full = LLMEncoderConfig.qwen25_7b()
    if (full.hidden_size, full.num_layers, full.num_heads, full.num_kv_heads, full.head_dim, full.intermediate_size,
            full.vocab_size, full.qkv_bias) != (3584, 28, 28, 4, 128, 18944, 152064, True):
        raise RuntimeError(f"not Qwen2.5-VL-7B's text trunk: {full}")

    def file_gb(layers: int) -> float:
        return sum(math.prod(v) for v in llm_checkpoint_shapes(dataclasses.replace(full, num_layers=layers))
                   .values()) / 1e9

    layers = full.num_layers if _full_depth(number, file_gb(full.num_layers) - file_gb(QWEN_FILE_LAYERS)) \
        else QWEN_FILE_LAYERS
    config = dataclasses.replace(full, num_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(270)
    root = os.path.join(paths["work"], "qwen25_vl")
    visual = {"visual.patch_embed.proj.weight": (0.02 * torch.randn(
        (1280, 3, 2, 14, 14), generator=gen, device="cuda")).to(torch.float8_e4m3fn)}
    write_s = write_llm_trunk(os.path.join(root, "text_encoder"), config, gen, {
        "architectures": ["Qwen2_5_VLForConditionalGeneration"], "model_type": "qwen2_5_vl",
        "max_position_embeddings": 128000, "hidden_act": "silu", "tie_word_embeddings": False,
        "rope_scaling": {"type": "mrope", "mrope_section": [16, 24, 24]},
        "vision_config": {"depth": 32, "hidden_size": 1280, "out_hidden_size": 3584, "patch_size": 14,
                          "temporal_patch_size": 2}}, extra=visual)
    paths["qwen"] = {"root": root, "config": config, "layers": [layers, full.num_layers],
                     "gb": sum(math.prod(v) for v in llm_checkpoint_shapes(config).values()) / 1e9,
                     "dtype": "float8_e4m3fn", "write_s": write_s, "written_by_phase": number}
    return paths["qwen"]


def _llm_text_report(spec, root: str, config, tokens: int, prompts: list, encoder=None) -> dict:
    """``prompts`` at ``tokens`` through the decoder-LLM encoder the trainer
    builds from ``root`` (or ``encoder``, built in memory; bf16 compute;
    ``config`` the one it must read): load seconds, prompts/s after a
    warm-up, and the bf16 states against the f32 module on the same weights
    and tokens (within ``LLM_BF16_REL_L2``)."""
    import gc

    import numpy as np
    import torch

    from simpletuner_tpu_torch.models.llm_encoder import LLMEncoder
    from simpletuner_tpu_torch.models.text_encoders import LLMTextEncoder, load_text_encoders

    load_s = None
    if encoder is None:
        t0 = time.perf_counter()
        (encoder,) = load_text_encoders([spec], pretrained_path=root, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    if not isinstance(encoder, LLMTextEncoder) or encoder.config != config or \
            encoder.model.embed_tokens.dtype != torch.bfloat16:
        raise RuntimeError(f"the {spec.family} builder gave {type(encoder).__name__} {encoder.config}")
    encoder.encode(prompts[:2])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = encoder.encode(prompts)
    encode_s = time.perf_counter() - t0
    with torch.device("cuda"):
        f32 = LLMEncoder(config, dtype=torch.float32)
    f32.load_state_dict({k: v.float() for k, v in encoder.model.state_dict().items()})
    out32 = LLMTextEncoder(spec, f32.eval(), encoder.tokenizer).encode(prompts)
    bf16_err = rel_l2(torch.from_numpy(out["last_hidden_state"]), torch.from_numpy(out32["last_hidden_state"]))
    valid = out["attention_mask"].sum(axis=1)
    if out["last_hidden_state"].shape != (len(prompts), tokens, config.hidden_size) or \
            not np.isfinite(out["last_hidden_state"]).all() or bf16_err > LLM_BF16_REL_L2 or \
            not (1 < valid).all() or not (valid < tokens).all():
        raise RuntimeError(f"{spec.family} encoder: {out['last_hidden_state'].shape}, bf16 vs f32 rel L2 {bf16_err} "
                           f"(<= {LLM_BF16_REL_L2}), valid tokens {valid.tolist()}")
    report = {"params": sum(p.numel() for p in encoder.model.parameters()), "load_s": load_s,
              "prompts": len(prompts), "tokens": tokens, "encode_s": encode_s,
              "prompts_per_s": len(prompts) / encode_s, "bf16_vs_f32_rel_l2": bf16_err, "bound": LLM_BF16_REL_L2,
              "valid_tokens": [int(valid.min()), int(valid.max())]}
    del encoder, f32, out, out32
    gc.collect()
    torch.cuda.empty_cache()
    return report


def write_byt5_tokenizer(root: str) -> None:
    """A byte-level tokenizer in ByT5's ids (``<pad>`` 0, ``</s>`` 1,
    ``<unk>`` 2, then byte b at b + 3, the eos appended) as a
    ``tokenizer.json`` that ``T5TokenizerFast`` reads (the T5 spec's
    tokenizer class; ByT5's own tokenizer has no fast form)."""
    from tokenizers import Tokenizer, models, processors

    pieces = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)] + [(chr(b), -1.0) for b in range(256)]
    tokenizer = Tokenizer(models.Unigram(pieces, unk_id=2))
    tokenizer.post_processor = processors.TemplateProcessing(single="$A </s>", special_tokens=[("</s>", 1)])
    os.makedirs(root, exist_ok=True)
    tokenizer.save(os.path.join(root, "tokenizer.json"))
    with open(os.path.join(root, "tokenizer_config.json"), "w") as handle:
        json.dump({"model_max_length": 1024, "eos_token": "</s>", "unk_token": "<unk>", "pad_token": "<pad>",
                   "extra_ids": 0}, handle)


def _video_config(family: str, root: str, data: str, cache: str, out: str, frames: int, steps: int,
                  alignment: int = 16, **extra) -> dict:
    """``Trainer.run()``'s config for a video family: the clips in ``data`` at
    640 pixel_area and ``alignment`` (16: 832 x 480, 768 x 512 and 848 x 480
    keep their size; LTX's 32: 768 x 512), rank-16 LoRA, bf16 base, every
    block checkpointed, AdamW 1e-4, one clip per VAE encode, graphed."""
    dataset = {"resolution": 640, "resolution_type": "pixel_area", "aspect_bucket_alignment": alignment}
    return {
        "model_family": family, "model_type": "lora", "lora_rank": 16, "pretrained_model_name_or_path": root,
        "gradient_checkpointing": True, "optimizer": "adamw", "learning_rate": 1e-4, "lr_scheduler": "constant",
        "mixed_precision": "bf16", "text_encoder_precision": "bf16", "train_batch_size": 1, "vae_batch_size": 1,
        "max_train_steps": steps, "logging_steps": 1, "report_to": "jsonl", "seed": 42, "cache_dir": cache,
        "output_dir": out, "checkpoint_frozen_base": "reference", **dataset, **extra,
        "data_backend_config": [
            {"id": "clips", "dataset_type": "video", "type": "local", "instance_data_dir": data, **dataset,
             "caption_strategy": "textfile", "cache_dir_vae": os.path.join(cache, "vae"),
             "video": {"num_frames": frames}},
            {"id": "embeds", "dataset_type": "text_embeds", "type": "local", "default": True,
             "cache_dir": os.path.join(cache, "text")},
        ],
    }


def _video_render(work: str, family: str, root: str, name: str, kernels, prompt: str, guidance: float, size: int,
                  frames: int, per_forward: int) -> tuple:
    """A true-CFG flow Euler render of ``frames`` frames at ``size`` px square
    through ``CheckpointInferenceRuntime``, written as mp4 and read back, with
    ``per_forward`` flash launches a forward (two forwards a step); returns
    the report and the runtime."""
    import torch

    from simpletuner_tpu_torch.inference import CheckpointInferenceRuntime

    config_path = os.path.join(work, f"{name}_render.json")
    with open(config_path, "w") as handle:
        json.dump({"model_family": family, "model_type": "full", "pretrained_model_name_or_path": root,
                   "mixed_precision": "bf16", "text_encoder_precision": "bf16", "seed": 42,
                   "validation_resolution": size, "validation_num_video_frames": frames, "validation_seed": 42,
                   "validation_guidance": guidance}, handle)
    t0 = time.perf_counter()
    runtime = CheckpointInferenceRuntime(config_path=config_path, output=os.path.join(work, f"{name}_render"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    timed = _timed_render(runtime, kernels, prompt, guidance)
    rendered, forward_s = timed["rendered"], timed["forward_s"]
    if timed["launches"] != {"flash_fwd": per_forward * 2 * STEPS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0} or \
            len(rendered) != 1 or not rendered[0].endswith(".mp4") or timed["finite"] != [True] or \
            len(forward_s) != 2 * STEPS:
        raise RuntimeError(f"{family} render: {rendered}, finite latents {timed['finite']}, {len(forward_s)} "
                           f"forwards, launches {timed['launches']}, expected {per_forward} per forward, two a step")
    read = _mp4_frame_shapes(rendered[0])
    if len(read) != frames or set(read) != {(size, size, 3)}:
        raise RuntimeError(f"{family} render: the mp4 holds {len(read)} frames of {set(read)}")
    return {"init_s": init_s, "render_s": timed["render_s"], "steps": STEPS, "guidance": guidance, "frames": frames,
            "size": size, "s_per_cfg_step": sum(forward_s[2:]) / (len(forward_s) - 2) * 2, "forward_s": forward_s,
            "vae_decode_s": timed["decode_s"][0], "peak_gib": timed["peak_gib"], "launches": timed["launches"],
            "launches_per_cfg_step": {k: v // STEPS for k, v in timed["launches"].items()},
            "launches_by_shape": timed["launches_by_shape"], "mp4": os.path.basename(rendered[0]),
            "mp4_bytes": os.path.getsize(rendered[0]), "mp4_frames": len(read)}, runtime


def _text_batch(model, prompt: str, latents: tuple, dev) -> dict:
    """Zero ``latents`` and ``prompt``'s collated conditioning on the card."""
    import torch

    batch = {"latents": torch.zeros(latents, device=dev)}
    for key, value in model.collate_text_embeds(model.encode_text([prompt])).items():
        batch[key] = torch.as_tensor(value, device=dev)
    return batch


def kandinsky5_phase(paths: dict, kernels, device: str, depth: int) -> dict:
    """Phase 27: Kandinsky 5.0 Lite at the JAX preset's full width and
    ``depth`` of its 32 visual blocks,
    both flavours on one seeded e4m3 transformer file, with phase 15's CLIP-L
    (``text_encoder_2``) and the seeded Qwen2.5-VL trunk (``qwen_trunk``,
    ``text_encoder``), both encoders reading ``tokenizer/`` (the CLIP
    tokenizer, which ``AutoTokenizer`` reads too), and a seeded 4-channel SD
    VAE (``vae/``, the image flavour's): 512-token prompts through the
    Qwen2.5-VL encoder (prompts/s, bf16 against the f32 module); the import
    through both family names held bitwise; ``kandinsky5_image`` at 1024 px:
    a true-CFG flow Euler render, one full-depth forward with the kernels
    against the plain attention, 6 graphed LoRA steps on four of phase 16's
    JPEGs; ``kandinsky5_video`` on two seeded 768 x 512 x 61 clips: 6 graphed
    LoRA steps after the video VAE cache, a true-CFG mp4 render at 512 px
    square, the parity forward on a 17-frame clip.  Each run's profiled
    replay is held to the capture's launches by shape (self / cross / text).
    Returns the launches per step of each kernel at the video shapes."""
    import gc

    import numpy as np
    import torch

    from simpletuner_tpu_torch.bench_cache import prompts_for
    from simpletuner_tpu_torch.inference import CheckpointInferenceRuntime, config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import kandinsky5_checkpoint_shapes, vae_checkpoint_shapes
    from simpletuner_tpu_torch.models.kandinsky5 import Kandinsky5Config, Kandinsky5Transformer, Kandinsky5Video
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from simpletuner_tpu_torch.models.video_vae import VideoAutoencoderKL, VideoVAEConfig
    from simpletuner_tpu_torch.models.weight_import import kandinsky5_params_from_checkpoint, save_safetensors

    start = time.perf_counter()
    work, flux_dir = paths["work"], paths["flux_dir"]
    for out in ("lumina2", "lumina2_train", "lumina2_cache", "lumina2_data", "lumina2_render"):  # disk space
        shutil.rmtree(os.path.join(work, out), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    tiny = Kandinsky5Config.tiny()
    wider = dataclasses.replace(tiny, model_dim=64, ff_dim=96, axes_dims=(8, 12, 12), num_text_blocks=2,
                                num_visual_blocks=1, in_visual_dim=3, out_visual_dim=5)
    flop_checks = _flop_checks(kandinsky5_step_flops, Kandinsky5Transformer, [
        (arch, (torch.zeros(2, t, h, w, arch.visual_embed_dim), torch.zeros(2, txt, arch.in_text_dim),
                torch.zeros(2, arch.in_text_dim2), torch.full((2,), 500.0)), (t * (h // 2) * (w // 2), txt))
        for arch, (t, h, w), txt in ((tiny, (3, 4, 6), 7), (wider, (1, 8, 6), 5))])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)
    full = Kandinsky5Config()
    if (full.model_dim, full.num_heads, full.head_dim, full.ff_dim, full.num_visual_blocks, full.num_text_blocks,
            full.in_visual_dim, full.in_text_dim) != (2048, 32, 64, 5120, 32, 2, 4, 3584):
        raise RuntimeError(f"not the JAX preset of Kandinsky 5.0 Lite: {full}")
    arch = dataclasses.replace(full, num_visual_blocks=depth)
    if K5_LATENT[0] * (K5_LATENT[1] // 2) * (K5_LATENT[2] // 2) != K5_TOKENS:
        raise RuntimeError(f"kandinsky5: {K5_LATENT} latents do not give {K5_TOKENS} tokens")
    shapes = kandinsky5_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    cut_bytes = sum(math.prod(shape) for shape in kandinsky5_checkpoint_shapes(
        dataclasses.replace(full, num_visual_blocks=K5_CUT_BLOCKS)).values())
    phase_gb = PHASE27_WRITE_GB + (file_bytes - cut_bytes) / 1e9  # the reservation is at the cut depth
    if free < file_bytes + 8e9 or written_before + phase_gb + _reserved(27) > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"kandinsky5: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the "
                           f"phase; it and the later phases write {phase_gb + _reserved(27):.1f} GB of the "
                           f"{RUN_WRITE_TARGET_GB} GB a run may write")

    # (b) the seeded files: the transformer (two e4m3 shards), the 4-channel
    # SD VAE (bf16), the Qwen2.5-VL trunk and phase 14's CLIP-L linked, and
    # the CLIP tokenizer in tokenizer/ (both specs read it; its config names
    # its class, so AutoTokenizer reads it as well)
    k5_dir = os.path.join(work, "kandinsky5")
    weights, write_s = _write_e4m3_transformer(k5_dir, shapes, gen)
    qwen = qwen_trunk(paths, 27)
    _link_tree(os.path.join(qwen["root"], "text_encoder"), os.path.join(k5_dir, "text_encoder"))
    _link_tree(os.path.join(flux_dir, "text_encoder"), os.path.join(k5_dir, "text_encoder_2"))
    os.makedirs(os.path.join(k5_dir, "tokenizer"))
    for name in os.listdir(os.path.join(flux_dir, "tokenizer")):
        shutil.copy(os.path.join(flux_dir, "tokenizer", name), os.path.join(k5_dir, "tokenizer", name))
    tok_config = os.path.join(k5_dir, "tokenizer", "tokenizer_config.json")
    with open(tok_config) as handle:
        values = json.load(handle)
    with open(tok_config, "w") as handle:
        json.dump({**values, "tokenizer_class": "CLIPTokenizer"}, handle)
    with torch.device(dev):
        vae = AutoencoderKL(VAEConfig(), torch.bfloat16)
    os.makedirs(os.path.join(k5_dir, "vae"))
    save_safetensors(seeded_weights(vae_checkpoint_shapes(vae), gen),
                     os.path.join(k5_dir, "vae", "diffusion_pytorch_model.safetensors"))
    del vae
    data = os.path.join(work, "k5_clips")
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "qwen": {k: v for k, v in qwen.items()
                                                                   if k not in ("root", "config")},
             **_write_clips(data, K5_CLIPS, K5_FRAMES, K5_HEIGHT, K5_WIDTH, 24, 27),
             "written_gb_before": written_before, "written_gb_after": _written_gb(), "free_gb_before": free / 1e9}

    # (c) 512-token prompts through the Qwen2.5-VL encoder the trainer builds
    prompts = [f"{TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]}, {p}" for i, p in enumerate(prompts_for(TEXT_PROMPTS))]
    text = _llm_text_report(Kandinsky5Video.TEXT_ENCODER_CONFIGURATION[0], k5_dir, qwen["config"], K5_TEXT,
                            prompts)

    # (d) the import through both family names, bitwise
    imported = {}
    for family in ("kandinsky5_video", "kandinsky5_image"):
        model = ModelRegistry.create(family, config_namespace({"model_family": family, "model_type": "full"}))
        if model.arch != arch:
            raise RuntimeError(f"{family}: the family builds {model.arch}, not {arch}")
        with torch.device(dev):
            module = model.create_module()
        imported[family] = _import_bitwise(model, module, k5_dir, weights, kandinsky5_params_from_checkpoint,
                                           file_bytes)
        del module
        gc.collect()
        torch.cuda.empty_cache()
    params = imported["kandinsky5_video"]["params"]
    del weights

    blocks = {"self": arch.num_visual_blocks, "cross": arch.num_visual_blocks, "text": arch.num_text_blocks}
    per_forward = sum(blocks.values())
    targets = [f"{a}.{p}" for a in ("self_attention", "cross_attention") for p in ("to_query", "to_key", "to_value",
                                                                                   "out_layer")]
    adapted_expected = {f"{a}/{p}" for a in ("self_attention", "cross_attention")
                        for p in ("to_query", "to_key", "to_value", "out_layer")}

    def shape_keys(tokens: int) -> dict:
        return {"self": f"32x{tokens}x{tokens}x64", "cross": f"32x{tokens}x{K5_TEXT}x64",
                "text": f"32x{K5_TEXT}x{K5_TEXT}x64"}

    def check_by_shape(by_shape: dict, tokens: int, label: str) -> None:
        keys = shape_keys(tokens)
        if by_shape["flash_fwd"] != {keys[n]: 2 * c for n, c in blocks.items()} or \
                any(by_shape[k] != {keys[n]: c for n, c in blocks.items()} for k in ("flash_bwd_dq", "flash_bwd_dkv")):
            raise RuntimeError(f"{label}: launches per step by shape {by_shape}")

    # (e) kandinsky5_image at 1024 px: render, parity, training
    config_path = os.path.join(work, "k5_image_render.json")
    with open(config_path, "w") as handle:
        json.dump({"model_family": "kandinsky5_image", "model_type": "full", "pretrained_model_name_or_path": k5_dir,
                   "mixed_precision": "bf16", "text_encoder_precision": "bf16", "vae_dtype": "bf16",
                   "validation_resolution": RESOLUTION, "validation_seed": 42, "seed": 42,
                   "validation_guidance": K5_GUIDANCE}, handle)
    t0 = time.perf_counter()
    runtime = CheckpointInferenceRuntime(config_path=config_path, output=os.path.join(work, "k5_image_render"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    module, model = runtime.module, runtime.model
    if model.arch != arch or model.NAME != "kandinsky5_image" or not model.is_flow:
        raise RuntimeError(f"kandinsky5_image: the runtime built {model.NAME} {model.arch}")
    timed = _timed_render(runtime, kernels, K5_PROMPT, K5_GUIDANCE)
    image_render = _render_report(timed, per_forward, K5_GUIDANCE, init_s)
    keys = shape_keys(K5_IMAGE_TOKENS)
    if timed["launches_by_shape"]["flash_fwd"] != {keys[n]: 2 * STEPS * c for n, c in blocks.items()}:
        raise RuntimeError(f"kandinsky5_image render: launches by shape {timed['launches_by_shape']}")
    latent = RESOLUTION // 8
    batch = _text_batch(model, K5_PROMPT, (1, latent, latent, 4), dev)
    if tuple(batch["text_embeds"].shape) != (1, K5_TEXT, arch.in_text_dim) or \
            tuple(batch["pooled_embeds"].shape) != (1, arch.in_text_dim2) or "text_attention_mask" in batch:
        raise RuntimeError(f"kandinsky5: the collated batch {({k: tuple(v.shape) for k, v in batch.items()})}")
    model.text_encoders = []  # the plain attention's scores need the room
    gc.collect()
    torch.cuda.empty_cache()
    noise = torch.randn((1, latent, latent, 4), generator=gen, device=dev)
    image_parity = {**_parity_forward(model, module, batch, noise, K5_SIGMA), "tokens": K5_IMAGE_TOKENS}
    del runtime, module, model, batch
    gc.collect()
    torch.cuda.empty_cache()

    images = _square_jpegs(work, "k5_image_data", K5_TRAIN_IMAGES)
    cache = os.path.join(work, "k5_image_cache")
    config = {
        "model_family": "kandinsky5_image", "model_type": "lora", "lora_rank": 16, "lora_target_modules": targets,
        "pretrained_model_name_or_path": k5_dir, "gradient_checkpointing": True, "optimizer": "adamw",
        "learning_rate": 1e-4, "lr_scheduler": "constant", "mixed_precision": "bf16", "text_encoder_precision": "bf16",
        "vae_dtype": "bf16", "train_batch_size": 1, "resolution": RESOLUTION, "resolution_type": "pixel_area",
        "max_train_steps": K5_TRAIN_STEPS, "logging_steps": 1, "report_to": "jsonl", "seed": 42, "cache_dir": cache,
        "output_dir": os.path.join(work, "k5_image_train"), "checkpoint_frozen_base": "reference",
        "data_backend_config": [
            {"id": "train", "dataset_type": "image", "type": "local", "instance_data_dir": images,
             "resolution": RESOLUTION, "resolution_type": "pixel_area", "caption_strategy": "textfile",
             "cache_dir_vae": os.path.join(cache, "vae")},
            {"id": "embeds", "dataset_type": "text_embeds", "type": "local", "default": True,
             "cache_dir": os.path.join(cache, "text")},
        ],
    }

    def check_image(trainer) -> dict:
        adapted = {name.rsplit("/", 3)[-3] + "/" + name.rsplit("/", 2)[-2] for name in trainer._state.trainable}
        batch = trainer._example_batch()
        if trainer.model.arch != arch or trainer.vae.config != VAEConfig() or adapted != adapted_expected or \
                batch["latents"].shape != (1, latent, latent, 4) or "text_attention_mask" in batch:
            raise RuntimeError(f"kandinsky5_image trainer: arch {trainer.model.arch}, VAE {trainer.vae.config}, "
                               f"adapters on {adapted}, batch {({k: v.shape for k, v in batch.items()})}")
        return {"vae": "VAEConfig() (SD, 4 latent channels, scaling 0.18215)"}

    expected = {"flash_fwd": 2 * per_forward, "flash_bwd_dq": per_forward, "flash_bwd_dkv": per_forward}
    flops = kandinsky5_step_flops(arch, 1, K5_IMAGE_TOKENS, K5_TEXT)
    image_train = _train_graphed(config, kernels, K5_TRAIN_STEPS, expected, flops, check_image)
    check_by_shape(image_train["launches_per_step_by_shape"], K5_IMAGE_TOKENS, "kandinsky5_image trainer")
    image_train.update({"base": "bf16", "remat": "every block", "lora_rank": 16})

    # (f) kandinsky5_video: training on the clips (the video VAE cache), the
    # mp4 render, the parity forward on a 17-frame clip
    cache = os.path.join(work, "k5_video_cache")
    config = _video_config("kandinsky5_video", k5_dir, data, cache, os.path.join(work, "k5_video_train"), K5_FRAMES,
                           K5_TRAIN_STEPS, lora_target_modules=targets)
    bucket = f"1.5x{K5_FRAMES}"

    def check_video(trainer) -> dict:
        bundle = trainer.data_plane.bundles["clips"]
        buckets = sorted(bundle.metadata_backend.aspect_ratio_bucket_indices)
        clips = bundle.metadata_backend.aspect_ratio_bucket_indices.get(bucket, [])
        cached = [bundle.vae_cache.load(p) for p in clips]
        vae_config = dataclasses.replace(VideoVAEConfig.wan(), latent_channels=4)
        if trainer.model.arch != arch or buckets != [bucket] or len(clips) != K5_CLIPS or \
                not isinstance(trainer.vae, VideoAutoencoderKL) or trainer.vae.config != vae_config or \
                any(c.shape != K5_LATENT + (4,) or not np.isfinite(c).all() for c in cached):
            raise RuntimeError(f"kandinsky5_video trainer: arch {trainer.model.arch}, buckets {buckets}, VAE "
                               f"{trainer.vae.config}, cached {[c.shape for c in cached]}")
        startup = trainer.data_plane.startup_metrics
        return {"buckets": buckets, "latents": list(cached[0].shape),
                "cache": {"text_s": startup.get("text_cache_clips_s"), "vae_s": startup.get("vae_cache_clips_s"),
                          "vae_s_per_clip": startup.get("vae_cache_clips_s", 0.0) / K5_CLIPS,
                          "init_data_backend_peak_gib": trainer.stage_report["init_data_backend"]["peak_gib"]}}

    flops = kandinsky5_step_flops(arch, 1, K5_TOKENS, K5_TEXT)
    video_train = _train_graphed(config, kernels, K5_TRAIN_STEPS, expected, flops, check_video)
    by_shape = video_train["launches_per_step_by_shape"]
    check_by_shape(by_shape, K5_TOKENS, "kandinsky5_video trainer")
    video_train.update({"base": "bf16", "remat": "every block", "lora_rank": 16, "flop_checks": flop_checks})

    video_render, runtime = _video_render(work, "kandinsky5_video", k5_dir, "k5_video", kernels, K5_PROMPT,
                                          K5_GUIDANCE, K5_RENDER_SIZE, K5_FRAMES, per_forward)
    module, model = runtime.module, runtime.model
    if model.arch != arch or model.NAME != "kandinsky5_video":
        raise RuntimeError(f"kandinsky5_video: the runtime built {model.NAME} {model.arch}")
    render_tokens = K5_LATENT[0] * (K5_RENDER_SIZE // 16) ** 2
    if video_render["launches_by_shape"]["flash_fwd"] != {
            shape_keys(render_tokens)[n]: 2 * STEPS * c for n, c in blocks.items()}:
        raise RuntimeError(f"kandinsky5_video render: launches by shape {video_render['launches_by_shape']}")
    video_render["tokens"] = render_tokens
    parity_latent = ((K5_PARITY_FRAMES - 1) // 4 + 1, K5_LATENT[1], K5_LATENT[2])
    batch = _text_batch(model, K5_PROMPT, (1,) + parity_latent + (4,), dev)
    model.text_encoders = []
    gc.collect()
    torch.cuda.empty_cache()
    noise = torch.randn((1,) + parity_latent + (4,), generator=gen, device=dev)
    video_parity = {**_parity_forward(model, module, batch, noise, K5_SIGMA), "frames": K5_PARITY_FRAMES,
                    "tokens": parity_latent[0] * (parity_latent[1] // 2) * (parity_latent[2] // 2)}
    del runtime, module, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    phase("27 kandinsky5", config="ai-forever/Kandinsky-5.0-T2V-Lite-sft-5s / T2I-Lite transformer/ as the JAX preset "
          "Kandinsky5Config() builds it (4 latent channels)", params=params, hidden=arch.model_dim,
          heads=[arch.num_heads, arch.head_dim], blocks=[arch.num_text_blocks, arch.num_visual_blocks],
          depth=[arch.num_visual_blocks, full.num_visual_blocks], ff_dim=arch.ff_dim,
          qwen_layers=qwen["layers"], clip=[K5_FRAMES, K5_HEIGHT, K5_WIDTH], latents=list(K5_LATENT),
          tokens={"image": K5_IMAGE_TOKENS, "video": K5_TOKENS, "text": K5_TEXT}, files=files, text_encoder=text,
          imported=imported, image={"render": image_render, "parity": image_parity, "train": image_train},
          video={"train": video_train, "render": video_render, "parity": video_parity},
          allocated_gib_before_phase=baseline_gib, seconds=time.perf_counter() - start, device=device)
    keys = shape_keys(K5_TOKENS)
    return {"k5_self": {k: v.get(keys["self"]) for k, v in by_shape.items()},
            "k5_cross": {k: v.get(keys["cross"]) for k, v in by_shape.items()}}


def hunyuanvideo_phase(paths: dict, kernels, device: str, depth: int) -> dict:
    """Phase 28: HunyuanVideo 1.5 t2v-480p at the JAX preset's full width and
    ``depth`` of its 54 dual-stream blocks: a seeded e4m3 diffusers
    transformer beside phase 27's Qwen2.5-VL trunk (linked, ``text_encoder``)
    with a Qwen-convention tokenizer (``tokenizer/``), a seeded ByT5-small in
    the T5 layout (``text_encoder_2``, bf16) with a byte-level tokenizer in
    ByT5's ids (``tokenizer_2``, read through ``T5TokenizerFast``), and two
    seeded 848 x 480 x 17 clips: 256-token prompts through the Qwen2.5-VL
    encoder (prompts/s); the import held bitwise; ``Trainer.run()`` (the
    video VAE cache at the Wan config and 32 latents, 6 graphed LoRA steps on
    the video attention projections, bf16 base, every dual-stream block
    checkpointed) with the profiled replay held to the capture's launches by
    shape; a true-CFG mp4 render at 480 px square and 17 frames; one forward
    with the kernels against the plain attention on a 5-frame clip with
    padded captions (the -1 pads in the refiner and the joint layers).
    Returns the launches per
    step of each kernel at the HunyuanVideo shapes."""
    import gc

    import numpy as np
    import torch

    from simpletuner_tpu_torch.bench_cache import prompts_for
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import hunyuanvideo_checkpoint_shapes
    from simpletuner_tpu_torch.models.hunyuanvideo import HunyuanVideo, HunyuanVideo15Config
    from simpletuner_tpu_torch.models.hunyuanvideo import HunyuanVideo15Transformer
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.t5 import T5Config, T5EncoderModel
    from simpletuner_tpu_torch.models.text_encoders import init_encoder
    from simpletuner_tpu_torch.models.video_vae import VideoAutoencoderKL, VideoVAEConfig
    from simpletuner_tpu_torch.models.weight_import import hunyuanvideo_params_from_diffusers, save_safetensors

    start = time.perf_counter()
    work, flux_dir = paths["work"], paths["flux_dir"]
    for out in ("kandinsky5", "k5_clips", "k5_image_data", "k5_image_cache", "k5_image_train", "k5_image_render",
                "k5_video_cache", "k5_video_train", "k5_video_render"):  # phase 27's: disk space
        shutil.rmtree(os.path.join(work, out), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    tiny = HunyuanVideo15Config.tiny()
    wider = dataclasses.replace(tiny, num_heads=3, head_dim=16, depth=1, refiner_depth=2, in_channels=5,
                                out_channels=3, axes_dim=(4, 6, 6))
    flop_checks = _flop_checks(hunyuanvideo_step_flops, HunyuanVideo15Transformer, [
        (arch, (torch.zeros(2, t, h, w, arch.in_channels), torch.full((2,), 0.5), torch.zeros(2, l1, arch.text_dim),
                torch.ones(2, l1, dtype=torch.int32), torch.zeros(2, l2, arch.text2_dim),
                torch.ones(2, l2, dtype=torch.int32)), (t * h * w, l1, l2))
        for arch, (t, h, w), l1, l2 in ((tiny, (2, 4, 6), 7, 5), (wider, (1, 6, 4), 5, 3))])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(28)
    full = HunyuanVideo15Config()
    if (full.hidden_size, full.num_heads, full.head_dim, full.depth, full.refiner_depth, full.in_channels,
            full.out_channels, full.text_dim, full.text2_dim) != (2048, 16, 128, 54, 2, 65, 32, 3584, 1472):
        raise RuntimeError(f"not the JAX preset of HunyuanVideo 1.5: {full}")
    arch = dataclasses.replace(full, depth=depth)
    byt5 = T5Config(vocab_size=384, d_model=1472, d_kv=64, d_ff=3584, num_layers=12, num_heads=6,
                    feed_forward_proj="gated-gelu")
    shapes = hunyuanvideo_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 6e9 or written_before + file_bytes / 1e9 + 0.55 + _reserved(28) > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"hunyuanvideo: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the "
                           f"phase; it writes {file_bytes / 1e9 + 0.55:.1f} GB of the {RUN_WRITE_TARGET_GB} GB a run "
                           "may write")

    # (b) the seeded files
    hy_dir = os.path.join(work, "hunyuanvideo")
    weights, write_s = _write_e4m3_transformer(hy_dir, shapes, gen)
    qwen = qwen_trunk(paths, 28)
    _link_tree(os.path.join(qwen["root"], "text_encoder"), os.path.join(hy_dir, "text_encoder"))
    write_gemma_tokenizer(os.path.join(hy_dir, "tokenizer"), " ".join(TRAIN_CAPTIONS + [HY_PROMPT]).split())
    write_byt5_tokenizer(os.path.join(hy_dir, "tokenizer_2"))
    with torch.device(dev):
        t5 = init_encoder(T5EncoderModel(byt5, torch.bfloat16), gen)
    os.makedirs(os.path.join(hy_dir, "text_encoder_2"))
    t0 = time.perf_counter()
    save_safetensors(t5.state_dict(), os.path.join(hy_dir, "text_encoder_2", "model.safetensors"))
    byt5_write_s = time.perf_counter() - t0
    byt5_bytes = sum(v.numel() * v.element_size() for v in t5.state_dict().values())
    del t5
    with open(os.path.join(hy_dir, "text_encoder_2", "config.json"), "w") as handle:
        json.dump({"architectures": ["T5ForConditionalGeneration"], "model_type": "t5", "d_model": 1472, "d_ff": 3584,
                   "d_kv": 64, "num_heads": 6, "num_layers": 12, "num_decoder_layers": 4,
                   "feed_forward_proj": "gated-gelu", "vocab_size": 384, "relative_attention_num_buckets": 32,
                   "relative_attention_max_distance": 128, "layer_norm_epsilon": 1e-6,
                   "tie_word_embeddings": False}, handle)
    data = os.path.join(work, "hy_clips")
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "byt5_gb": byt5_bytes / 1e9, "byt5_dtype": "bfloat16",
             "byt5_write_s": byt5_write_s, "qwen": {"linked_from_phase": qwen["written_by_phase"],
                                                   "layers": qwen["layers"]},
             **_write_clips(data, HY_CLIPS, HY_FRAMES, HY_HEIGHT, HY_WIDTH, 24, 28),
             "written_gb_before": written_before, "written_gb_after": _written_gb(), "free_gb_before": free / 1e9}

    # (c) 256-token prompts through the Qwen2.5-VL encoder
    prompts = [f"{TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]}, {p}" for i, p in enumerate(prompts_for(TEXT_PROMPTS))]
    text = _llm_text_report(HunyuanVideo.TEXT_ENCODER_CONFIGURATION[0], hy_dir, qwen["config"], HY_TEXT, prompts)

    # (d) the import, bitwise
    model = ModelRegistry.create("hunyuanvideo", config_namespace({"model_family": "hunyuanvideo",
                                                                   "model_type": "full"}))
    if model.arch != arch:
        raise RuntimeError(f"hunyuanvideo: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()
    imported = _import_bitwise(model, module, hy_dir, weights, hunyuanvideo_params_from_diffusers, file_bytes)
    params = imported["params"]
    del weights, module
    gc.collect()
    torch.cuda.empty_cache()

    # (e) Trainer.run() on the clips: rank-16 LoRA on the video attention projections
    joint_key, refiner_key = f"16x{HY_JOINT}x{HY_JOINT}x128", f"16x{HY_TEXT}x{HY_TEXT}x128"
    cache = os.path.join(work, "hy_cache")
    config = _video_config("hunyuanvideo", hy_dir, data, cache, os.path.join(work, "hy_train"), HY_FRAMES,
                           HY_TRAIN_STEPS, lora_target_modules=list(HunyuanVideo.DEFAULT_LORA_TARGET))
    bucket = f"1.77x{HY_FRAMES}"

    def check(trainer) -> dict:
        bundle = trainer.data_plane.bundles["clips"]
        buckets = sorted(bundle.metadata_backend.aspect_ratio_bucket_indices)
        clips = bundle.metadata_backend.aspect_ratio_bucket_indices.get(bucket, [])
        cached = [bundle.vae_cache.load(p) for p in clips]
        adapted = {name.rsplit("/", 2)[-2] for name in trainer._state.trainable}
        batch = trainer._example_batch()
        vae_config = dataclasses.replace(VideoVAEConfig.wan(), latent_channels=32)
        if trainer.model.arch != arch or buckets != [bucket] or len(clips) != HY_CLIPS or \
                not isinstance(trainer.vae, VideoAutoencoderKL) or trainer.vae.config != vae_config or \
                any(c.shape != HY_LATENT + (32,) or not np.isfinite(c).all() for c in cached) or \
                adapted != set(HunyuanVideo.DEFAULT_LORA_TARGET) or batch["text_mask"].shape != (1, HY_TEXT) or \
                batch["text_mask_2"].shape != (1, HY_TEXT2) or not 1 < int(batch["text_mask"].sum()) < HY_TEXT:
            raise RuntimeError(f"hunyuanvideo trainer: arch {trainer.model.arch}, buckets {buckets}, VAE "
                               f"{trainer.vae.config}, cached {[c.shape for c in cached]}, adapters {adapted}, batch "
                               f"{({k: v.shape for k, v in batch.items()})}")
        startup = trainer.data_plane.startup_metrics
        return {"buckets": buckets, "latents": list(cached[0].shape), "lora_targets": sorted(adapted),
                "caption_valid": {"qwen": int(batch["text_mask"].sum()), "byt5": int(batch["text_mask_2"].sum())},
                "cache": {"text_s": startup.get("text_cache_clips_s"), "vae_s": startup.get("vae_cache_clips_s"),
                          "vae_s_per_clip": startup.get("vae_cache_clips_s", 0.0) / HY_CLIPS,
                          "init_data_backend_peak_gib": trainer.stage_report["init_data_backend"]["peak_gib"]}}

    # the refiner's two attentions run once (no remat, nothing to train
    # behind them: no backward); every dual-stream block's forward, its
    # recompute and its backward
    expected = {"flash_fwd": 2 * arch.depth + arch.refiner_depth, "flash_bwd_dq": arch.depth,
                "flash_bwd_dkv": arch.depth}
    flops = hunyuanvideo_step_flops(arch, 1, HY_VIDEO, HY_TEXT, HY_TEXT2)
    train = _train_graphed(config, kernels, HY_TRAIN_STEPS, expected, flops, check)
    by_shape = train["launches_per_step_by_shape"]
    if by_shape["flash_fwd"] != {joint_key: 2 * arch.depth, refiner_key: arch.refiner_depth} or \
            any(by_shape[k] != {joint_key: arch.depth} for k in ("flash_bwd_dq", "flash_bwd_dkv")):
        raise RuntimeError(f"hunyuanvideo trainer: launches per step by shape {by_shape}")
    train.update({"base": "bf16", "remat": "every dual-stream block", "lora_rank": 16, "flop_checks": flop_checks})

    # (f) the mp4 render; (g) the parity forward on a 5-frame clip with padded captions
    per_forward = arch.depth + arch.refiner_depth
    render, runtime = _video_render(work, "hunyuanvideo", hy_dir, "hy", kernels, HY_PROMPT, HY_GUIDANCE,
                                    HY_RENDER_SIZE, HY_FRAMES, per_forward)
    module, model = runtime.module, runtime.model
    if model.arch != arch or model.NAME != "hunyuanvideo":
        raise RuntimeError(f"hunyuanvideo: the runtime built {model.NAME} {model.arch}")
    render_joint = HY_LATENT[0] * (HY_RENDER_SIZE // 8) ** 2 + HY_TEXT + HY_TEXT2
    if render["launches_by_shape"]["flash_fwd"] != {f"16x{render_joint}x{render_joint}x128": 2 * STEPS * arch.depth,
                                                    refiner_key: 2 * STEPS * arch.refiner_depth}:
        raise RuntimeError(f"hunyuanvideo render: launches by shape {render['launches_by_shape']}")
    render["tokens"] = render_joint
    parity_latent = ((HY_PARITY_FRAMES - 1) // 4 + 1, HY_LATENT[1], HY_LATENT[2])
    batch = _text_batch(model, HY_PROMPT, (1,) + parity_latent + (32,), dev)
    valid = {"qwen": int(batch["text_mask"].sum()), "byt5": int(batch["text_mask_2"].sum())}
    if not (1 < valid["qwen"] < HY_TEXT and 1 < valid["byt5"] < HY_TEXT2):
        raise RuntimeError(f"hunyuanvideo parity: the captions are not padded: {valid}")
    model.text_encoders = []
    gc.collect()
    torch.cuda.empty_cache()
    noise = torch.randn((1,) + parity_latent + (32,), generator=gen, device=dev)
    parity = {**_parity_forward(model, module, batch, noise, HY_SIGMA), "frames": HY_PARITY_FRAMES,
              "tokens": math.prod(parity_latent) + HY_TEXT + HY_TEXT2, "caption_valid": valid}
    del runtime, module, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    phase("28 hunyuanvideo", config="tencent/HunyuanVideo-1.5 transformer/ (t2v-480p) as the JAX preset "
          "HunyuanVideo15Config() builds it", params=params, hidden=arch.hidden_size,
          heads=[arch.num_heads, arch.head_dim], blocks=[arch.refiner_depth, arch.depth], depth=[arch.depth, full.depth],
          clip=[HY_FRAMES, HY_HEIGHT, HY_WIDTH], latents=list(HY_LATENT),
          tokens={"video": HY_VIDEO, "qwen": HY_TEXT, "byt5": HY_TEXT2, "joint": HY_JOINT}, files=files,
          text_encoder=text, imported=imported, train=train, render=render, parity=parity,
          allocated_gib_before_phase=baseline_gib, seconds=time.perf_counter() - start, device=device)
    return {"hy_joint": {k: v.get(joint_key) for k, v in by_shape.items()},
            "hy_refiner": {k: v.get(refiner_key, 0) for k, v in by_shape.items()}}  # no backward: 0


def qwen_image_step_flops(arch, batch: int, img_tokens: int, txt_tokens: int) -> int:
    """Model FLOPs of one Qwen-Image (Z-Image, MageFlow) train step in
    bench.py's convention (forward x 3; remat recompute is hardware work, not
    model work), counted from the config: ``img_in`` and ``txt_in``, the time
    MLP; per double-stream block both streams' modulation linears (per
    sample), q / k / v / out and the MLP per token, and the joint
    attention's two products over every token; the head."""
    d, inner, mlp = arch.hidden_size, arch.num_heads * arch.head_dim, int(arch.hidden_size * arch.mlp_ratio)
    joint = img_tokens + txt_tokens
    fwd = 2 * img_tokens * arch.in_channels * d + 2 * txt_tokens * arch.txt_in_features * d + 2 * (256 * d + d * d)
    fwd += arch.depth * (2 * 2 * d * 6 * d + joint * (8 * d * inner + 4 * d * mlp) + 4 * joint * joint * inner)
    fwd += 2 * d * 2 * d + 2 * img_tokens * d * arch.in_channels
    return batch * fwd * 3


def hidream_step_flops(arch, batch: int, img_tokens: int, t5_tokens: int, llama_tokens: int) -> int:
    """Model FLOPs of one HiDream-I1 train step in bench.py's convention
    (forward x 3), counted from the config: the time and pooled MLPs, the
    patch linear, the T5 and the per-block Llama caption projections (one
    per block); per double block its adaLN, q / k / v / out over the image
    and the text ([T5, llama[last], llama[block]]), the joint attention's two
    products, the MoE over the image tokens and SwiGLU over the text; per
    single block the same over the merged stream with the MoE over every
    token; the MoE with its gate, all E experts (both packages compute them
    densely), the routed sum and the shared expert; the head."""
    d, h, hs, e = arch.hidden_size, arch.ffn_inner, arch.shared_ffn_inner, arch.num_experts
    patch = arch.patch_size ** 2 * arch.in_channels
    text = t5_tokens + 2 * llama_tokens  # the persistent [T5, llama[last]] and the block's llama segment
    joint = img_tokens + text
    n_blocks = arch.depth_double + arch.depth_single

    def moe(tokens: int) -> int:
        return tokens * (2 * d * e + e * 6 * d * h + 2 * e * d + 6 * d * hs)

    fwd = 2 * (256 * d + d * d) + 2 * (arch.pooled_dim * d + d * d) + 2 * img_tokens * patch * d
    fwd += 2 * t5_tokens * arch.t5_dim * d + n_blocks * 2 * llama_tokens * arch.llama_dim * d
    fwd += arch.depth_double * (2 * d * 12 * d + joint * 8 * d * d + 4 * joint * joint * d + moe(img_tokens) +
                                text * 6 * d * h)
    fwd += arch.depth_single * (2 * d * 6 * d + joint * 8 * d * d + 4 * joint * joint * d + moe(joint))
    fwd += 2 * d * 2 * d + 2 * img_tokens * d * patch
    return batch * fwd * 3


def _image_train_config(family: str, root, data: str, cache: str, out: str, steps: int, **extra) -> dict:
    """``Trainer.run()``'s config for an image family on ``data`` at 1024 px
    (from the model dir ``root``, or None with the paths in ``extra``):
    rank-16 LoRA on an int8 base (``quantized_matmul: full``), every block
    checkpointed, AdamW 1e-4, bf16, one square bucket, graphed."""
    return {
        "model_family": family, "model_type": "lora", "lora_rank": 16,
        **({"pretrained_model_name_or_path": root} if root else {}),
        "base_model_precision": "int8-quanto", "quantized_matmul": "full", "gradient_checkpointing": True,
        "optimizer": "adamw", "learning_rate": 1e-4, "lr_scheduler": "constant", "mixed_precision": "bf16",
        "text_encoder_precision": "bf16", "vae_dtype": "bf16", "train_batch_size": 1, "resolution": RESOLUTION,
        "resolution_type": "pixel_area", "max_train_steps": steps, "logging_steps": 1, "report_to": "jsonl",
        "seed": 42, "cache_dir": cache, "output_dir": out, "checkpoint_frozen_base": "reference", **extra,
        "data_backend_config": [
            {"id": "train", "dataset_type": "image", "type": "local", "instance_data_dir": data,
             "resolution": RESOLUTION, "resolution_type": "pixel_area", "caption_strategy": "textfile",
             "cache_dir_vae": os.path.join(cache, "vae")},
            {"id": "embeds", "dataset_type": "text_embeds", "type": "local", "default": True,
             "cache_dir": os.path.join(cache, "text")},
        ],
    }


def _image_render(work: str, family: str, root: str, name: str, kernels, prompt: str, guidance: float,
                  keys: dict) -> tuple:
    """A 1024 px true-CFG render through ``CheckpointInferenceRuntime``
    (``_render_report``) whose every forward launches the forward kernel
    ``keys[shape]`` times at each shape; returns the report and the runtime."""
    import torch

    from simpletuner_tpu_torch.inference import CheckpointInferenceRuntime

    config_path = os.path.join(work, f"{name}_render.json")
    with open(config_path, "w") as handle:
        json.dump({"model_family": family, "model_type": "full", "pretrained_model_name_or_path": root,
                   "mixed_precision": "bf16", "text_encoder_precision": "bf16", "vae_dtype": "bf16",
                   "validation_resolution": RESOLUTION, "validation_seed": 42, "seed": 42,
                   "validation_guidance": guidance}, handle)
    t0 = time.perf_counter()
    runtime = CheckpointInferenceRuntime(config_path=config_path, output=os.path.join(work, f"{name}_render"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    timed = _timed_render(runtime, kernels, prompt, guidance)
    report = _render_report(timed, sum(keys.values()), guidance, init_s)
    if timed["launches_by_shape"]["flash_fwd"] != {key: 2 * STEPS * n for key, n in keys.items()}:
        raise RuntimeError(f"{family} render: launches by shape {timed['launches_by_shape']}")
    return report, runtime


def _graph_matches_eager(trainer, keys) -> dict:
    """One replay of the trainer's captured step and one eager step from the
    same state and generator state (the state put back after each): the
    metrics ``keys`` bitwise equal."""
    import torch

    from simpletuner_tpu_torch.training.train_state import state_tensors

    graphed = next(iter(trainer._graphs.values()))
    state, generator = trainer._state, trainer._generator
    with torch.no_grad():
        saved = [x.clone() for x in state_tensors(state)]
    rng, step = generator.get_state(), state.step

    def restore():
        with torch.no_grad():
            for x, value in zip(state_tensors(state), saved):
                x.copy_(value)
        generator.set_state(rng)
        state.step = step

    _, replayed = graphed(state, graphed.batch, generator)
    restore()
    _, eager = trainer._step_fn(state, graphed.batch, generator)
    eager = {k: v.clone() for k, v in eager.items()}
    restore()
    equal = {k: bool(torch.equal(replayed[k], eager[k])) for k in keys}
    if not all(equal.values()):
        raise RuntimeError(f"{trainer.model.NAME}: the replayed step's {({k: float(replayed[k]) for k in keys})} "
                           f"differ from the eager step's {({k: float(eager[k]) for k in keys})}")
    return {"graph_equals_eager_bitwise": equal, **{f"{k}_replayed": float(replayed[k]) for k in keys}}


def qwen_image_phase(paths: dict, kernels, device: str, depth: int) -> dict:
    """Phase 29: Qwen-Image at the JAX preset's full width and ``depth`` of its
    60 blocks: a seeded e4m3 diffusers transformer beside phase 27's
    Qwen2.5-VL trunk (``qwen_trunk``, linked as ``text_encoder``), a
    Qwen-convention tokenizer (``tokenizer/``) and phase 14's Flux VAE:
    1024-token prompts through the Qwen2.5-VL encoder (prompts/s, bf16
    against f32); the import held bitwise; a 1024 px true-CFG flow Euler
    render; one forward with the kernels against the plain attention (the
    1,024 text tokens unmasked, as the JAX family collates them); 6 graphed
    LoRA steps through ``Trainer.run()`` on an int8 base with the profiled
    replay held to the capture's launches by shape.  Then Z-Image at
    ``ZI_CUT_BLOCKS`` of its 19 blocks built in memory, with a seeded
    2560-wide qwen2-layout trunk at ``ZI_TRUNK_LAYERS`` layers: the parity
    forward at 4,096 text tokens and 6 graphed LoRA steps on an int8 base.
    MageFlow does not run: its published arch takes 32 latent channels, the
    Flux VAE its trainer builds gives 16 (ROADMAP Queue 3).  Returns the
    launches per step of each kernel at the two joint shapes."""
    import gc

    import torch

    from simpletuner_tpu_torch.bench_cache import prompts_for
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import qwen_image_checkpoint_shapes
    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.mageflow import MageFlow, ZImage
    from simpletuner_tpu_torch.models.qwen_image import QwenImage, QwenImageConfig, QwenImageTransformer
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.text_encoders import load_text_encoders
    from simpletuner_tpu_torch.models.vae import VAEConfig
    from simpletuner_tpu_torch.models.weight_import import qwen_image_params_from_diffusers

    start = time.perf_counter()
    work, flux_dir = paths["work"], paths["flux_dir"]
    for out in ("hunyuanvideo", "hy_clips", "hy_cache", "hy_train", "hy_render"):  # phase 28's: disk space
        shutil.rmtree(os.path.join(work, out), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    tiny = QwenImageConfig.tiny()
    wider = dataclasses.replace(tiny, hidden_size=96, num_heads=3, depth=1, mlp_ratio=3.0, in_channels=8,
                                txt_in_features=20, txt_rope=False)
    flop_checks = _flop_checks(qwen_image_step_flops, QwenImageTransformer, [
        (arch, (torch.zeros(2, hh * ww, arch.in_channels), (hh, ww), torch.zeros(2, txt, arch.txt_in_features),
                torch.full((2,), 0.5)), (hh * ww, txt))
        for arch, (hh, ww), txt in ((tiny, (3, 4), 7), (wider, (2, 5), 5))])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(29)
    full = QwenImageConfig()
    if (full.hidden_size, full.num_heads, full.head_dim, full.depth, full.in_channels, full.txt_in_features,
            full.axes_dim, full.txt_rope) != (3072, 24, 128, 60, 64, 3584, (16, 56, 56), True):
        raise RuntimeError(f"not the JAX preset of Qwen-Image: {full}")
    arch = dataclasses.replace(full, depth=depth)
    shapes = qwen_image_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 6e9 or written_before + file_bytes / 1e9 + 1.0 + _reserved(29) > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"qwen_image: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the "
                           f"phase; it and the later phases write {file_bytes / 1e9 + 1.0 + _reserved(29):.1f} GB of "
                           f"the {RUN_WRITE_TARGET_GB} GB a run may write")

    # (b) the seeded files: the transformer (two e4m3 shards), the Qwen trunk
    # and phase 14's Flux VAE linked, a Qwen-convention tokenizer in tokenizer/
    qi_dir = os.path.join(work, "qwen_image")
    weights, write_s = _write_e4m3_transformer(qi_dir, shapes, gen)
    qwen = qwen_trunk(paths, 29)
    _link_tree(os.path.join(qwen["root"], "text_encoder"), os.path.join(qi_dir, "text_encoder"))
    _link_tree(os.path.join(flux_dir, "vae"), os.path.join(qi_dir, "vae"))
    prompts = [f"{TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]}, {p}" for i, p in enumerate(prompts_for(TEXT_PROMPTS))]
    words = " ".join(TRAIN_CAPTIONS + [QI_PROMPT] + prompts).split()
    write_gemma_tokenizer(os.path.join(qi_dir, "tokenizer"), words)
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9,
             "qwen": {"written_by_phase": qwen["written_by_phase"], "layers": qwen["layers"]},
             "written_gb_before": written_before, "written_gb_after": _written_gb(), "free_gb_before": free / 1e9}

    # (c) 1024-token prompts through the Qwen2.5-VL encoder the trainer builds
    text = _llm_text_report(QwenImage.TEXT_ENCODER_CONFIGURATION[0], qi_dir, qwen["config"], QI_TEXT, prompts)

    # (d) the import, bitwise
    model = ModelRegistry.create("qwen_image", config_namespace({"model_family": "qwen_image", "model_type": "full"}))
    if model.arch != arch:
        raise RuntimeError(f"qwen_image: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()
    imported = _import_bitwise(model, module, qi_dir, weights, qwen_image_params_from_diffusers, file_bytes)
    params = imported["params"]
    del weights, module
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the render and (f) the parity forward, the Qwen tokens unmasked
    joint = QI_IMG + QI_TEXT
    joint_key = f"24x{joint}x{joint}x128"
    render, runtime = _image_render(work, "qwen_image", qi_dir, "qi", kernels, QI_PROMPT, QI_GUIDANCE,
                                    {joint_key: depth})
    module, model = runtime.module, runtime.model
    if model.arch != arch or model.NAME != "qwen_image" or not model.is_flow:
        raise RuntimeError(f"qwen_image: the runtime built {model.NAME} {model.arch}")
    latent = RESOLUTION // 8
    batch = _text_batch(model, QI_PROMPT, (1, latent, latent, 16), dev)
    if sorted(batch) != ["latents", "text_embeds"] or tuple(batch["text_embeds"].shape) != (1, QI_TEXT, 3584):
        raise RuntimeError(f"qwen_image: the collated batch {({k: tuple(v.shape) for k, v in batch.items()})}")
    model.text_encoders = []  # the plain attention's scores need the room
    gc.collect()
    torch.cuda.empty_cache()
    noise = torch.randn((1, latent, latent, 16), generator=gen, device=dev)
    parity = {**_parity_forward(model, module, batch, noise, QI_SIGMA), "tokens": joint}
    del runtime, module, model, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (g) Trainer.run(): int8 base, every adapter-carrying linear (the JAX
    # family's default), 6 graphed steps on four of phase 16's JPEGs
    def check(trainer, expected_arch, txt) -> dict:
        batch = trainer._example_batch()
        conditioning = sorted(k for k in batch if "embeds" in k or "mask" in k)  # the mask is dropped
        if trainer.model.arch != expected_arch or trainer.vae.config != VAEConfig.flux() or \
                trainer.model.base_precision != "int8" or conditioning != ["text_embeds"] or \
                batch["text_embeds"].shape[1] != txt or batch["latents"].shape != (1, latent, latent, 16):
            raise RuntimeError(f"{trainer.model.NAME} trainer: arch {trainer.model.arch}, VAE {trainer.vae.config}, "
                               f"base {trainer.model.base_precision}, batch "
                               f"{({k: v.shape for k, v in batch.items()})}")
        return {"vae": "VAEConfig.flux() (16 latent channels)", **_graph_matches_eager(trainer, ("loss", "grad_norm"))}

    data = _square_jpegs(work, "qi_data", QI_TRAIN_IMAGES)
    cache = os.path.join(work, "qi_cache")
    config = _image_train_config("qwen_image", qi_dir, data, cache, os.path.join(work, "qi_train"), QI_TRAIN_STEPS)
    expected = {"flash_fwd": 2 * depth, "flash_bwd_dq": depth, "flash_bwd_dkv": depth}
    flops = qwen_image_step_flops(arch, 1, QI_IMG, QI_TEXT)
    train = _train_graphed(config, kernels, QI_TRAIN_STEPS, expected, flops, lambda t: check(t, arch, QI_TEXT))
    by_shape = train["launches_per_step_by_shape"]
    if any(by_shape[k] != {joint_key: n} for k, n in expected.items()):
        raise RuntimeError(f"qwen_image trainer: launches per step by shape {by_shape}")
    train.update({"base": "int8", "quantized_matmul": "full", "remat": "every block", "lora_rank": 16,
                  "flop_checks": flop_checks})
    shutil.rmtree(os.path.join(work, "qi_cache"), ignore_errors=True)

    # (h) Z-Image: a seeded 2560-wide qwen2-layout trunk (Qwen3-4B's sizes)
    # at ZI_TRUNK_LAYERS layers with the tokenizer and the Flux VAE; the DiT
    # at ZI_CUT_BLOCKS blocks built in memory (seeded from the trainer's seed)
    zarch = QwenImageConfig(in_channels=64, depth=ZI_CUT_BLOCKS, txt_in_features=2560, txt_rope=False)
    zmodel = ZImage(config_namespace({"model_family": "z_image", "model_type": "full"}))
    if zmodel.arch != zarch or MageFlow.LATENT_CHANNEL_COUNT != 32 or ZImage.LATENT_CHANNEL_COUNT != 16:
        raise RuntimeError(f"z_image: the family builds {zmodel.arch}, not {zarch}")
    z_dir = os.path.join(work, "z_image")
    trunk = zi_trunk_config()
    trunk_write_s = write_llm_trunk(os.path.join(z_dir, "text_encoder"), trunk, gen, QWEN3_HF)
    paths["zi_trunk"] = os.path.join(z_dir, "text_encoder")  # phase 34 links it
    write_gemma_tokenizer(os.path.join(z_dir, "tokenizer"), words)
    _link_tree(os.path.join(flux_dir, "vae"), os.path.join(z_dir, "vae"))
    z_joint = QI_IMG + ZI_TEXT
    z_key = f"24x{z_joint}x{z_joint}x128"
    zmodel.attach_text_encoders(load_text_encoders(ZImage.TEXT_ENCODER_CONFIGURATION, pretrained_path=z_dir,
                                                   device=dev))
    if zmodel.text_encoders[0].config != trunk:
        raise RuntimeError(f"z_image: the qwen2.5 spec read {zmodel.text_encoders[0].config}, not {trunk}")
    batch = _text_batch(zmodel, QI_PROMPT, (1, latent, latent, 16), dev)
    if tuple(batch["text_embeds"].shape) != (1, ZI_TEXT, 2560):
        raise RuntimeError(f"z_image: text_embeds {tuple(batch['text_embeds'].shape)}")
    zmodel.text_encoders = []
    with torch.device(dev):
        zmodule = init_parameters(zmodel.create_module(), torch.Generator(device=dev).manual_seed(42))
    z_parity = {**_parity_forward(zmodel, zmodule, batch, torch.randn((1, latent, latent, 16), generator=gen,
                                                                        device=dev), QI_SIGMA), "tokens": z_joint}
    del zmodule, zmodel, batch
    gc.collect()
    torch.cuda.empty_cache()
    cache = os.path.join(work, "zi_cache")
    config = _image_train_config("z_image", None, data, cache, os.path.join(work, "zi_train"), QI_TRAIN_STEPS,
                                 allow_untrained_init=True, pretrained_text_encoder_model_name_or_path=z_dir,
                                 pretrained_vae_model_name_or_path=os.path.join(z_dir, "vae"))
    expected = {"flash_fwd": 2 * ZI_CUT_BLOCKS, "flash_bwd_dq": ZI_CUT_BLOCKS, "flash_bwd_dkv": ZI_CUT_BLOCKS}
    z_flops = qwen_image_step_flops(zarch, 1, QI_IMG, ZI_TEXT)
    z_train = _train_graphed(config, kernels, QI_TRAIN_STEPS, expected, z_flops,
                             lambda t: check(t, zarch, ZI_TEXT))
    z_by_shape = z_train["launches_per_step_by_shape"]
    if any(z_by_shape[k] != {z_key: n} for k, n in expected.items()):
        raise RuntimeError(f"z_image trainer: launches per step by shape {z_by_shape}")
    z_train.update({"base": "int8 (built in memory)", "quantized_matmul": "full", "remat": "every block",
                    "lora_rank": 16})
    shutil.rmtree(cache, ignore_errors=True)
    phase("29 qwen_image", config="Qwen/Qwen-Image transformer/ as the JAX preset QwenImageConfig() builds it",
          params=params, hidden=arch.hidden_size, heads=[arch.num_heads, arch.head_dim], depth=[arch.depth, full.depth],
          qwen_layers=qwen["layers"], tokens={"image": QI_IMG, "text": QI_TEXT, "joint": joint}, files=files,
          text_encoder=text, imported=imported, render=render, parity=parity, train=train,
          z_image={"config": "Tongyi-MAI/Z-Image-Turbo as the JAX family builds it (qwen_image DiT, txt_rope off)",
                   "depth": [ZI_CUT_BLOCKS, 19], "params": sum(math.prod(v) for v in qwen_image_checkpoint_shapes(
                       zarch).values()), "trunk": {"layers": [ZI_TRUNK_LAYERS, 36], "write_s": trunk_write_s,
                                                   "hidden": trunk.hidden_size},
                   "tokens": {"image": QI_IMG, "text": ZI_TEXT, "joint": z_joint}, "parity": z_parity,
                   "train": z_train},
          mageflow="not run: LATENT_CHANNEL_COUNT 32 against the 16-channel Flux VAE its trainer builds (Queue 3)",
          allocated_gib_before_phase=baseline_gib, seconds=time.perf_counter() - start, device=device)
    return {"qi_joint": {k: v.get(joint_key) for k, v in by_shape.items()},
            "zi_joint": {k: v.get(z_key) for k, v in z_by_shape.items()}}


def hidream_phase(paths: dict, kernels, device: str, depth: tuple) -> dict:
    """Phase 30: HiDream-I1 at the JAX preset's full width and ``depth``
    (double, single) of its 16 + 32 blocks: a seeded e4m3 diffusers
    transformer beside phase 14's CLIP-L (``text_encoder``), phase 19's CLIP-G
    (``text_encoder_2``), phase 15's T5-XXL (``text_encoder_3``) and its T5
    tokenizer (``tokenizer_2``, the subfolder the T5 spec reads), a seeded
    Llama-3.1-8B trunk (``text_encoder_4``), phase 15's CLIP tokenizer in
    ``tokenizer/`` (the CLIP and the Llama specs read it) and phase 14's Flux
    VAE: 128-token prompts through the Llama encoder (prompts/s, bf16 against
    f32); the import held bitwise; a 1024 px true-CFG render; one forward
    with the kernels against the plain attention; 6 graphed LoRA steps
    through ``Trainer.run()`` on an int8 base with the load-balancing loss on,
    ``moe_gate_loss`` logged at every step and a replay's equal to the eager
    step's bitwise, the profiled replay held to the capture's launches.
    Returns the launches per step of each kernel at the joint shape."""
    import gc

    import numpy as np
    import torch

    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import hidream_checkpoint_shapes
    from simpletuner_tpu_torch.models.hidream import HiDream, HiDreamConfig, HiDreamTransformer
    from simpletuner_tpu_torch.models.llm_encoder import LLMEncoderConfig
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.vae import VAEConfig
    from simpletuner_tpu_torch.models.weight_import import hidream_params_from_diffusers

    start = time.perf_counter()
    work, flux_dir = paths["work"], paths["flux_dir"]
    for out in ("qwen_image", "qi_data", "qi_train", "qi_render", "zi_train"):  # phase 29's (its trunk: phase 34's)
        shutil.rmtree(os.path.join(work, out), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    tiny = HiDreamConfig.tiny()
    wider = dataclasses.replace(tiny, num_heads=3, head_dim=16, depth_double=2, depth_single=1, num_experts=3,
                                top_k=2, pooled_dim=20, t5_dim=24, llama_dim=28, in_channels=3, axes_dim=(8, 4, 4))
    flop_checks = _flop_checks(hidream_step_flops, HiDreamTransformer, [
        (arch, (torch.zeros(2, h, w, arch.in_channels), torch.full((2,), 0.5), torch.zeros(2, t5, arch.t5_dim),
                torch.zeros(2, n_sel, ll, arch.llama_dim), torch.zeros(2, arch.pooled_dim)),
         ((h // 2) * (w // 2), t5, ll)) for arch, (h, w), t5, ll, n_sel in ((tiny, (8, 6), 5, 4, 1),
                                                                           (wider, (4, 8), 3, 6, 2))])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(30)
    full = HiDreamConfig()
    if (full.hidden_size, full.num_heads, full.head_dim, full.depth_double, full.depth_single, full.num_experts,
            full.top_k, full.ffn_inner, full.shared_ffn_inner, full.t5_dim, full.llama_dim, full.pooled_dim) != \
            (2560, 20, 128, 16, 32, 4, 2, 6912, 3584, 4096, 4096, 2048):
        raise RuntimeError(f"not the JAX preset of HiDream-I1: {full}")
    arch = dataclasses.replace(full, depth_double=depth[0], depth_single=depth[1])
    shapes = hidream_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 6e9 or written_before + file_bytes / 1e9 + 1.2 > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"hidream: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the phase; "
                           f"it writes {file_bytes / 1e9 + 1.2:.1f} GB of the {RUN_WRITE_TARGET_GB} GB a run may write")

    # (b) the seeded files and the links
    hd_dir = os.path.join(work, "hidream")
    weights, write_s = _write_e4m3_transformer(hd_dir, shapes, gen)
    llama = dataclasses.replace(LLMEncoderConfig.llama3_8b(), num_layers=LLAMA_FILE_LAYERS)
    llama_write_s = write_llm_trunk(os.path.join(hd_dir, "text_encoder_4"), llama, gen, {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama", "max_position_embeddings": 131072,
        "hidden_act": "silu", "tie_word_embeddings": False,
        "rope_scaling": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                         "original_max_position_embeddings": 8192}})
    for source, target in ((os.path.join(flux_dir, "text_encoder"), "text_encoder"),
                           (os.path.join(work, "sd3", "text_encoder_2"), "text_encoder_2"),
                           (os.path.join(flux_dir, "text_encoder_2"), "text_encoder_3"),
                           (os.path.join(flux_dir, "tokenizer_2"), "tokenizer_2"),
                           (os.path.join(flux_dir, "vae"), "vae")):
        _link_tree(source, os.path.join(hd_dir, target))
    os.makedirs(os.path.join(hd_dir, "tokenizer"))
    for name in os.listdir(os.path.join(flux_dir, "tokenizer")):
        shutil.copy(os.path.join(flux_dir, "tokenizer", name), os.path.join(hd_dir, "tokenizer", name))
    tok_config = os.path.join(hd_dir, "tokenizer", "tokenizer_config.json")
    with open(tok_config) as handle:
        values = json.load(handle)
    with open(tok_config, "w") as handle:  # its class named, so that AutoTokenizer (the Llama builder) reads it
        json.dump({**values, "tokenizer_class": "CLIPTokenizer"}, handle)
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "llama_layers": [LLAMA_FILE_LAYERS, 32],
             "llama_write_s": llama_write_s, "written_gb_before": written_before, "written_gb_after": _written_gb(),
             "free_gb_before": free / 1e9}

    # (c) 128-token prompts through the Llama encoder (the CLIP tokenizer of
    # tokenizer/, one token a character: short captions)
    prompts = [f"{TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]} #{i}" for i in range(TEXT_PROMPTS)]
    text = _llm_text_report(HiDream.TEXT_ENCODER_CONFIGURATION[3], hd_dir, llama, HD_TEXT, prompts)

    # (d) the import, bitwise
    model = ModelRegistry.create("hidream", config_namespace({"model_family": "hidream", "model_type": "full"}))
    if model.arch != arch:
        raise RuntimeError(f"hidream: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()
    imported = _import_bitwise(model, module, hd_dir, weights, hidream_params_from_diffusers, file_bytes)
    params = imported["params"]
    del weights, module
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the render and (f) the parity forward
    joint_key = f"20x{HD_JOINT}x{HD_JOINT}x128"
    per_forward = depth[0] + depth[1]
    render, runtime = _image_render(work, "hidream", hd_dir, "hd", kernels, HD_PROMPT, HD_GUIDANCE,
                                    {joint_key: per_forward})
    module, model = runtime.module, runtime.model
    if model.arch != arch or model.NAME != "hidream" or not model.is_flow:
        raise RuntimeError(f"hidream: the runtime built {model.NAME} {model.arch}")
    latent = RESOLUTION // 8
    batch = _text_batch(model, HD_PROMPT, (1, latent, latent, 16), dev)
    collated = {k: tuple(v.shape) for k, v in batch.items()}
    if collated != {"latents": (1, latent, latent, 16), "t5_embeds": (1, HD_TEXT, 4096),
                    "llama_embeds": (1, 1, HD_TEXT, 4096), "pooled_embeds": (1, 2048)}:
        raise RuntimeError(f"hidream: the collated batch {collated}")
    model.text_encoders = []
    gc.collect()
    torch.cuda.empty_cache()
    noise = torch.randn((1, latent, latent, 16), generator=gen, device=dev)
    parity = {**_parity_forward(model, module, batch, noise, HD_SIGMA), "tokens": HD_JOINT}
    del runtime, module, model, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (g) Trainer.run(): int8 base, every adapter-carrying linear, the
    # load-balancing loss on; moe_gate_loss logged and graphed = eager
    def check(trainer) -> dict:
        with open(os.path.join(config["output_dir"], "simpletuner-tpu-metrics.jsonl")) as handle:
            gate = [json.loads(line).get("moe_gate_loss") for line in handle]
        batch = trainer._example_batch()
        if trainer.model.arch != arch or trainer.vae.config != VAEConfig.flux() or \
                trainer.model.base_precision != "int8" or trainer.model.moe_aux_weight != 0.01 or \
                not all(g is not None and np.isfinite(g) and g > 0 for g in gate) or \
                {k: v.shape for k, v in batch.items() if "embeds" in k or "mask" in k} != {
                    "t5_embeds": (1, HD_TEXT, 4096), "llama_embeds": (1, 1, HD_TEXT, 4096),
                    "pooled_embeds": (1, 2048)}:
            raise RuntimeError(f"hidream trainer: arch {trainer.model.arch}, VAE {trainer.vae.config}, base "
                               f"{trainer.model.base_precision}, moe_gate_loss {gate}, batch "
                               f"{({k: v.shape for k, v in batch.items()})}")
        return {"moe_gate_loss": gate, "moe_aux_weight": trainer.model.moe_aux_weight,
                **_graph_matches_eager(trainer, ("loss", "grad_norm", "moe_gate_loss"))}

    data = _square_jpegs(work, "hd_data", HD_TRAIN_IMAGES)
    cache = os.path.join(work, "hd_cache")
    config = _image_train_config("hidream", hd_dir, data, cache, os.path.join(work, "hd_train"), HD_TRAIN_STEPS,
                                 hidream_use_load_balancing_loss=True)
    expected = {"flash_fwd": 2 * per_forward, "flash_bwd_dq": per_forward, "flash_bwd_dkv": per_forward}
    flops = hidream_step_flops(arch, 1, QI_IMG, HD_TEXT, HD_TEXT)
    train = _train_graphed(config, kernels, HD_TRAIN_STEPS, expected, flops, check)
    by_shape = train["launches_per_step_by_shape"]
    if any(by_shape[k] != {joint_key: n} for k, n in expected.items()):
        raise RuntimeError(f"hidream trainer: launches per step by shape {by_shape}")
    train.update({"base": "int8", "quantized_matmul": "full", "remat": "every block", "lora_rank": 16,
                  "flop_checks": flop_checks})
    phase("30 hidream", config="HiDream-ai/HiDream-I1-Full transformer/ as the JAX preset HiDreamConfig() builds it",
          params=params, hidden=arch.hidden_size, heads=[arch.num_heads, arch.head_dim],
          experts=[arch.num_experts, arch.top_k], depth=[[arch.depth_double, arch.depth_single],
                                                        [full.depth_double, full.depth_single]],
          tokens={"image": QI_IMG, "t5": HD_TEXT, "llama": HD_TEXT, "joint": HD_JOINT}, files=files,
          text_encoder=text, imported=imported, render=render, parity=parity, train=train,
          allocated_gib_before_phase=baseline_gib, seconds=time.perf_counter() - start, device=device)
    return {"hd_joint": {k: v.get(joint_key) for k, v in by_shape.items()}}


def flux2_step_flops(arch, batch: int, img_tokens: int, txt_tokens: int) -> int:
    """Model FLOPs of one FLUX.2 train step in bench.py's convention (forward
    x 3; remat recompute is hardware work, not model work), counted from the
    config: the time (and guidance) MLPs, the three shared modulations and
    ``final_mod`` (per sample), ``patch_in`` and ``txt_in``; per double block
    q / k / v / out and the SwiGLU feed-forward (fused gate and up) over every
    token and the joint attention's two products; per single block the fused
    ``qkv_mlp`` and ``proj_out`` over every token and the attention; the head."""
    d, inner, mlp = arch.hidden_size, arch.num_heads * arch.head_dim, arch.mlp_hidden
    packed = arch.patch_size ** 2 * arch.in_channels
    joint = img_tokens + txt_tokens
    fwd = (2 if arch.guidance_embed else 1) * 2 * (256 * d + d * d) + 2 * d * (6 * d + 6 * d + 3 * d + 2 * d)
    fwd += 2 * img_tokens * packed * d + 2 * txt_tokens * arch.txt_in_features * d
    fwd += arch.depth_double * (joint * (8 * d * inner + 6 * d * mlp) + 4 * joint * joint * inner)
    fwd += arch.depth_single * (joint * 2 * d * (4 * inner + 3 * mlp) + 4 * joint * joint * inner)
    fwd += 2 * img_tokens * d * packed
    return batch * fwd * 3


def _graph_vs_eager(model, module, batch: dict, kernels, steps: int, expected: dict, flops: float,
                    metric_keys: tuple = ()) -> dict:
    """LoRA steps of ``model``'s ``module`` on ``batch`` through
    ``build_train_step`` and ``jit_train_step``, as ``Trainer.run()`` builds
    them (the step captured as one CUDA graph): two eager runs of 2 steps and
    2 replays from one snapshot of the state and the generator (the replays'
    losses, grad norms and LoRA tensors no further from the first eager run
    than the second is: bitwise where the eager runs are), then ``steps``
    replays timed (s/step median, MFU of ``flops``, peak GiB) and one
    profiled (``bench.replay_launches``: device ms by bucket, idle share, the
    launches held to the capture's and to ``expected`` a step); the
    wrappers' launches by shape per step (they count the two warm-up steps
    and the capture); the last replay's ``metric_keys`` metrics."""
    import numpy as np
    import torch

    from simpletuner_tpu_torch.bench import replay_launches
    from simpletuner_tpu_torch.training.optimizers import get_optimizer
    from simpletuner_tpu_torch.training.schedules import get_lr_schedule
    from simpletuner_tpu_torch.training.train_state import (
        build_train_step, create_train_state, jit_train_step, state_tensors,
    )

    torch.cuda.reset_peak_memory_stats()
    schedule = get_lr_schedule(model.config, steps)
    tx = get_optimizer(model.config, schedule)
    state = create_train_state(model, module, tx, quantize_mode=model.base_precision)
    step_fn = build_train_step(model, tx, schedule)
    gen = torch.Generator(device="cuda").manual_seed(42)
    with torch.no_grad():
        saved = [x.clone() for x in state_tensors(state)]
    rng = gen.get_state()

    def restore():
        with torch.no_grad():
            for tensor, value in zip(state_tensors(state), saved):
                tensor.copy_(value)
        gen.set_state(rng)

    def trajectory(step):
        current, losses, norms = state, [], []
        for _ in range(2):
            current, metrics = step(current, batch, gen)
            losses.append(metrics["loss"])
            norms.append(metrics["grad_norm"])
        return torch.stack(losses), torch.stack(norms), torch.cat([p.detach().flatten()
                                                                    for p in current.trainable.values()]).clone()

    def max_diff(a, b):
        return [float((x.float() - y.float()).abs().max()) for x, y in zip(a, b)]

    first = trajectory(step_fn)
    restore()
    eager_diff = max_diff(first, trajectory(step_fn))
    restore()
    for kernel in kernels:
        kernel.launches = 0
        kernel.shape_launches.clear()
    t0 = time.perf_counter()
    graphed = jit_train_step(step_fn, state, batch, gen)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    by_shape = _per_shape(kernels, 3)
    captured = {counter.name: count for counter, count in graphed.captured_launches.items()}
    replayed = trajectory(graphed)
    graph_diff = max_diff(replayed, first)
    if any(g > e for g, e in zip(graph_diff, eager_diff)) or not torch.isfinite(replayed[0]).all():
        raise RuntimeError(f"{model.NAME} graphed step: replays {replayed[0].tolist()} differ from the eager steps "
                           f"{first[0].tolist()} by {graph_diff} (two eager runs: {eager_diff})")
    step_s, losses = [], []
    current = state
    for _ in range(steps):
        t0 = time.perf_counter()
        current, metrics = graphed(current, batch, gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    profile = replay_launches(lambda: graphed(current, batch, gen), captured,
                              {kernel.name: kernel.name for kernel in kernels})
    device_launches = {kernel.name: profile["bucket_launches"][kernel.name] for kernel in kernels}
    if device_launches != {k: captured[k] for k in device_launches} or device_launches != expected or \
            not all(np.isfinite(losses)):
        raise RuntimeError(f"{model.NAME} graphed step: the profiled replay launched {device_launches}, the "
                           f"capture recorded {captured}, expected {expected}; losses {losses}")
    median_s = float(np.median(step_s))
    report = {"lora_params": sum(p.numel() for p in state.trainable.values()), "losses": losses,
              "grad_norm": float(metrics["grad_norm"]), "step_s": step_s, "s_per_step_median": median_s,
              "flops_per_step": flops, "mfu": flops / median_s / PEAK_BF16_FLOPS, "capture_s": capture_s,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "bitwise_equal_to_eager": graph_diff == [0.0, 0.0, 0.0], "graph_vs_eager_max_diff": graph_diff,
              "eager_vs_eager_max_diff": eager_diff, "launches_captured": captured,
              "launches_profiled_replay": device_launches, "launches_per_step_by_shape": by_shape,
              "profile": {k: profile[k] for k in ("bucket_ms", "bucket_launches", "launch_attempts", "device_ms",
                                                  "traced_event_ms", "idle_share_traced", "top_kernels")},
              **{key: float(metrics[key]) for key in metric_keys}}
    del graphed, state, current, saved
    return report


def flux2_phase(paths: dict, kernels, device: str, depth: tuple) -> dict:
    """Phase 31: FLUX.2-dev at the JAX preset's full width and ``depth``
    (double, single) of its 8 + 48 blocks: a seeded e4m3 diffusers
    transformer and a word-level tokenizer; a seeded Mistral-3 24B trunk at
    ``MISTRAL_LAYERS`` layers built in memory, whose three taps
    (``F2_TAPS``) through ``Flux2.encode_text`` make the 15,360 features of
    16 prompts at 512 tokens (prompts/s, bf16 against f32); the import held
    bitwise; one forward with the kernels against the plain attention; the
    guidance-distilled flow Euler loop over 32-channel latents (s per step,
    no decode); 6 graphed LoRA steps on an int8 base (``_graph_vs_eager``).
    Then the klein width at 1 + 1 blocks built in memory: one parity forward
    and 2 graphed steps; in a run that names the phase, the 6 graphed steps
    at all 8 + 48 blocks built in memory too.  Returns the launches per step
    of each kernel at the joint shape."""
    import gc

    import numpy as np
    import torch

    from simpletuner_tpu_torch.bench_cache import prompts_for
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import flux2_checkpoint_shapes
    from simpletuner_tpu_torch.models.flux2 import Flux2, Flux2Config, Flux2Transformer
    from simpletuner_tpu_torch.models.layers import init_adapters, init_parameters
    from simpletuner_tpu_torch.models.llm_encoder import LLMEncoder, LLMEncoderConfig
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.text_encoders import LLMTextEncoder, _tokenizer
    from simpletuner_tpu_torch.models.weight_import import flux2_params_from_diffusers, load_transformer_params
    from simpletuner_tpu_torch.schedulers.sampling import sample_loop
    from simpletuner_tpu_torch.training.validation import build_scheduler

    start = time.perf_counter()
    work = paths["work"]
    for out in ("hidream", "hd_data", "hd_train", "hd_render", "hd_cache"):  # phase 30's: disk space
        shutil.rmtree(os.path.join(work, out), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    tiny = Flux2Config.tiny()
    narrow = dataclasses.replace(tiny, num_heads=3, depth_double=2, depth_single=1, in_channels=3, mlp_ratio=2.0,
                                 txt_in_features=20, axes_dim=(2, 6, 4, 4), guidance_embed=False)
    flop_checks = _flop_checks(flux2_step_flops, Flux2Transformer, [
        (arch, (torch.zeros(2, h, w, arch.in_channels), torch.full((2,), 0.5),
                torch.zeros(2, txt, arch.txt_in_features), torch.full((2,), 4.0) if arch.guidance_embed else None),
         ((h // 2) * (w // 2), txt))
        for arch, (h, w), txt in ((tiny, (6, 8), 5), (narrow, (4, 10), 3))])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    full = Flux2Config()
    if (full.hidden_size, full.num_heads, full.head_dim, full.depth_double, full.depth_single, full.in_channels,
            full.txt_in_features, full.mlp_hidden, full.axes_dim, full.rope_theta, full.guidance_embed) != \
            (6144, 48, 128, 8, 48, 32, 15360, 18432, (32, 32, 32, 32), 2000.0, True):
        raise RuntimeError(f"not the JAX preset of FLUX.2-dev: {full}")
    arch = dataclasses.replace(full, depth_double=depth[0], depth_single=depth[1])
    shapes = flux2_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 6e9 or written_before + file_bytes / 1e9 + 0.2 + _reserved(31) > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"flux2: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the phase; "
                           f"it and the later phases write {file_bytes / 1e9 + 0.2 + _reserved(31):.1f} GB of the "
                           f"{RUN_WRITE_TARGET_GB} GB a run may write")

    # (b) the seeded transformer (two e4m3 shards) and a word-level tokenizer
    f2_dir = os.path.join(work, "flux2")
    weights, write_s = _write_e4m3_transformer(f2_dir, shapes, gen)
    prompts = [f"{TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]}, {p}" for i, p in enumerate(prompts_for(TEXT_PROMPTS))]
    write_gemma_tokenizer(os.path.join(f2_dir, "tokenizer"), " ".join(TRAIN_CAPTIONS + [F2_PROMPT] + prompts).split())
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "written_gb_before": written_before,
             "written_gb_after": _written_gb(), "free_gb_before": free / 1e9}

    # (c) Mistral-3 24B at full width and MISTRAL_LAYERS layers, seeded in
    # memory; 512-token prompts with the three taps through Flux2.encode_text
    mistral_full = LLMEncoderConfig.mistral3_24b()
    if (mistral_full.hidden_size, mistral_full.num_layers, mistral_full.num_heads, mistral_full.num_kv_heads,
            mistral_full.head_dim, mistral_full.intermediate_size, mistral_full.vocab_size,
            mistral_full.rope_theta) != (5120, 40, 32, 8, 128, 32768, 131072, 1e8):
        raise RuntimeError(f"not Mistral-3 24B's trunk: {mistral_full}")
    mistral = dataclasses.replace(mistral_full, num_layers=MISTRAL_LAYERS)
    spec = Flux2.TEXT_ENCODER_CONFIGURATION[0]
    t0 = time.perf_counter()
    with torch.device(dev):
        trunk = LLMEncoder(mistral)
    trunk.reset_parameters(torch.Generator(device=dev).manual_seed(310))
    encoder = LLMTextEncoder(spec, trunk.eval(), _tokenizer("AutoTokenizer", f2_dir, "tokenizer"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    text = _llm_text_report(spec, None, mistral, F2_TEXT, prompts, encoder=encoder)
    values = {"model_family": "flux2", "model_type": "full", "flux_guidance_value": F2_GUIDANCE,
              "custom_text_encoder_intermediary_layers": F2_TAPS, "mixed_precision": "bf16"}
    tapping = Flux2(config_namespace(values))
    tapping.attach_text_encoders([encoder])
    tapping.encode_text(prompts[:2])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tapped = np.stack([p["text_embeds"] for p in tapping.encode_text(prompts)])
    taps_s = time.perf_counter() - t0
    with torch.device(dev):
        trunk32 = LLMEncoder(mistral, dtype=torch.float32)
    trunk32.load_state_dict({k: v.float() for k, v in trunk.state_dict().items()})
    tapping.attach_text_encoders([LLMTextEncoder(spec, trunk32.eval(), encoder.tokenizer)])
    tapped32 = np.stack([p["text_embeds"] for p in tapping.encode_text(prompts)])
    taps_err = rel_l2(torch.from_numpy(tapped), torch.from_numpy(tapped32))
    del trunk32, tapped32
    if tapped.shape != (TEXT_PROMPTS, F2_TEXT, 3 * mistral.hidden_size) or not np.isfinite(tapped).all() or \
            taps_err > LLM_BF16_REL_L2:
        raise RuntimeError(f"flux2 text: {tapped.shape}, taps bf16 vs f32 rel L2 {taps_err} (<= {LLM_BF16_REL_L2})")
    text.update({"layers": [MISTRAL_LAYERS, mistral_full.num_layers], "built_in_memory_s": build_s,
                 "taps": F2_TAPS, "taps_features": int(tapped.shape[-1]), "taps_encode_s": taps_s,
                 "taps_prompts_per_s": TEXT_PROMPTS / taps_s, "taps_bf16_vs_f32_rel_l2": taps_err})
    tapping.attach_text_encoders([encoder])
    latent = RESOLUTION // 8
    batch = _text_batch(tapping, F2_PROMPT, (1, latent, latent, 32), dev)
    if {k: tuple(v.shape) for k, v in batch.items()} != {"latents": (1, latent, latent, 32),
                                                         "text_embeds": (1, F2_TEXT, 15360)}:
        raise RuntimeError(f"flux2: the collated batch {({k: tuple(v.shape) for k, v in batch.items()})}")
    del tapped, encoder, trunk, tapping
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the import, bitwise
    model = ModelRegistry.create("flux2", config_namespace(values))
    if model.arch != arch:
        raise RuntimeError(f"flux2: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()
    imported = _import_bitwise(model, module, f2_dir, weights, flux2_params_from_diffusers, file_bytes)
    params = imported["params"]
    del weights
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the parity forward over the 4,608 joint tokens, the text unmasked
    joint_key = f"48x{F2_JOINT}x{F2_JOINT}x128"
    per_forward = depth[0] + depth[1]
    noise = torch.randn((1, latent, latent, 32), generator=gen, device=dev)
    parity = {**_parity_forward(model, module, batch, noise, F2_SIGMA), "tokens": F2_JOINT}

    # (f) the guidance-distilled flow Euler loop (one forward a step), no decode
    forward_s = []

    def before(mod, args, kwargs):
        torch.cuda.synchronize()
        forward_s.append(-time.perf_counter())

    def after(mod, args, kwargs, out):
        torch.cuda.synchronize()
        forward_s[-1] += time.perf_counter()

    hooks = [module.register_forward_pre_hook(before, with_kwargs=True),
             module.register_forward_hook(after, with_kwargs=True)]
    for kernel in kernels:
        kernel.launches = 0
        kernel.shape_launches.clear()
    try:
        t0 = time.perf_counter()
        with torch.no_grad():
            latents = sample_loop(build_scheduler(model, STEPS), model.denoise_fn(module, model.inference_conditioning(
                batch)), torch.randn((1, latent, latent, 32), generator=gen, device=dev))
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    finally:
        for hook in hooks:
            hook.remove()
    launches = {kernel.name: kernel.launches for kernel in kernels}
    if launches != {"flash_fwd": STEPS * per_forward, "flash_bwd_dq": 0, "flash_bwd_dkv": 0} or \
            _per_shape(kernels)["flash_fwd"] != {joint_key: STEPS * per_forward} or len(forward_s) != STEPS or \
            tuple(latents.shape) != (1, latent, latent, 32) or not torch.isfinite(latents).all():
        raise RuntimeError(f"flux2 sampler: launches {launches} ({_per_shape(kernels)}), {len(forward_s)} forwards, "
                           f"latents {tuple(latents.shape)} finite {bool(torch.isfinite(latents).all())}")
    sampler = {"steps": STEPS, "guidance": F2_GUIDANCE, "loop_s": loop_s, "forward_s": forward_s,
               "s_per_euler_step": sum(forward_s[1:]) / (STEPS - 1), "launches": launches,
               "decode": "none: no VAE of either package decodes FLUX.2's 32 channels (ROADMAP Queue 3)"}
    del module, latents
    gc.collect()
    torch.cuda.empty_cache()

    # (g) 6 graphed rank-16 LoRA steps on an int8 base, every block checkpointed
    train_values = {**values, "model_type": "lora", "lora_rank": 16, "base_model_precision": "int8-quanto",
                    "quantized_matmul": "full", "gradient_checkpointing": True, "optimizer": "adamw",
                    "learning_rate": 1e-4, "lr_scheduler": "constant", "max_train_steps": F2_TRAIN_STEPS, "seed": 42}
    train_model = Flux2(config_namespace(train_values))
    with torch.device(dev):
        train_module = load_transformer_params(train_model, init_adapters(train_model.create_module(), gen), f2_dir)
    batch = {**batch, "latents": torch.randn((1, latent, latent, 32), generator=gen, device=dev)}
    expected = {"flash_fwd": 2 * per_forward, "flash_bwd_dq": per_forward, "flash_bwd_dkv": per_forward}
    train = _graph_vs_eager(train_model, train_module, batch, kernels, F2_TRAIN_STEPS, expected,
                            flux2_step_flops(arch, 1, F2_IMG, F2_TEXT))
    by_shape = train["launches_per_step_by_shape"]
    if any(by_shape[k] != {joint_key: n} for k, n in expected.items()):
        raise RuntimeError(f"flux2 train: launches per step by shape {by_shape}")
    train.update({"base": "int8", "quantized_matmul": "full", "remat": "every block", "lora_rank": 16,
                  "lora_targets": "every adapter-carrying linear (the JAX family's default)",
                  "flop_checks": flop_checks})
    del train_module
    gc.collect()
    torch.cuda.empty_cache()

    # (h) the klein width (24 heads, no guidance) at 1 + 1 blocks built in memory
    klein_values = {**values, "model_flavour": "klein"}
    kmodel = Flux2(config_namespace(klein_values))
    karch = dataclasses.replace(Flux2Config.klein(), depth_double=1, depth_single=1)
    if kmodel.arch != karch or kmodel.arch.guidance_embed:
        raise RuntimeError(f"flux2 klein: the family builds {kmodel.arch}, not {karch}")
    with torch.device(dev):
        kmodule = init_parameters(kmodel.create_module(), torch.Generator(device=dev).manual_seed(42))
    klein_parity = {**_parity_forward(kmodel, kmodule, batch, noise, F2_SIGMA), "tokens": F2_JOINT}
    del kmodule
    ktrain_model = Flux2(config_namespace({**train_values, "model_flavour": "klein"}))
    with torch.device(dev):
        ktrain_module = init_parameters(ktrain_model.create_module(), torch.Generator(device=dev).manual_seed(42))
    klein_key = f"24x{F2_JOINT}x{F2_JOINT}x128"
    kexpected = {"flash_fwd": 4, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    klein_train = _graph_vs_eager(ktrain_model, ktrain_module, batch, kernels, 2, kexpected,
                                  flux2_step_flops(karch, 1, F2_IMG, F2_TEXT))
    if any(klein_train["launches_per_step_by_shape"][k] != {klein_key: n} for k, n in kexpected.items()):
        raise RuntimeError(f"flux2 klein train: launches by shape {klein_train['launches_per_step_by_shape']}")
    del ktrain_module
    gc.collect()
    torch.cuda.empty_cache()

    # (i) a run that names the phase: the 6 graphed steps at all 8 + 48 blocks, built in memory
    # (bf16 at 64 GB, then the int8 base at 32 GB; nothing written)
    full_train = "not run: a run that names the phase (--phases 31) builds all 8 + 48 blocks in memory"
    if RUN["requested"] is not None and 31 in RUN["requested"]:
        fmodel = Flux2(config_namespace(train_values), arch=full)
        with torch.device(dev):
            fmodule = init_parameters(fmodel.create_module(), torch.Generator(device=dev).manual_seed(42))
        n = full.depth_double + full.depth_single
        fexpected = {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
        full_train = _graph_vs_eager(fmodel, fmodule, batch, kernels, F2_TRAIN_STEPS, fexpected,
                                     flux2_step_flops(full, 1, F2_IMG, F2_TEXT))
        if any(full_train["launches_per_step_by_shape"][k] != {joint_key: v} for k, v in fexpected.items()):
            raise RuntimeError(f"flux2 full-depth train: launches by shape {full_train['launches_per_step_by_shape']}")
        full_train.update({"depth": [full.depth_double, full.depth_single], "base": "int8 (built in memory)"})
        del fmodule
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    phase("31 flux2", config="black-forest-labs/FLUX.2-dev transformer/ as the JAX preset Flux2Config() builds it",
          params=params, hidden=arch.hidden_size, heads=[arch.num_heads, arch.head_dim],
          depth=[[arch.depth_double, arch.depth_single], [full.depth_double, full.depth_single]],
          tokens={"image": F2_IMG, "text": F2_TEXT, "joint": F2_JOINT}, latent_channels=arch.in_channels,
          files=files, text_encoder=text, imported=imported, parity=parity, sampler=sampler, train=train,
          klein={"config": "Flux2Config.klein() (24 heads, no guidance) built in memory", "depth": [[1, 1], [5, 20]],
                 "params": sum(math.prod(v) for v in flux2_checkpoint_shapes(karch).values()),
                 "parity": klein_parity, "train": klein_train},
          full_depth_train=full_train, allocated_gib_before_phase=baseline_gib,
          seconds=time.perf_counter() - start, device=device)
    return {"f2_joint": {k: v.get(joint_key) for k, v in by_shape.items()}}


def kolors_phase(paths: dict, kernels, device: str, layers: tuple) -> dict:
    """Phase 32: Kolors at the JAX family's full width with ``layers`` the
    transformer depth of its three levels: a seeded e4m3 diffusers UNet, a
    seeded ChatGLM3-6B trunk at ``GLM_FILE_LAYERS`` layers with ChatGLM's
    ``config.json``, a word-level tokenizer and phase 20's SDXL VAE (linked,
    or written here): 256-token prompts through the ChatGLM encoder
    (prompts/s, bf16 against f32); the import held bitwise; a 1024 px
    true-CFG DDIM render with its launches by shape; one UNet forward with the
    kernels against the plain attention; 6 graphed LoRA steps through
    ``Trainer.run()`` (bf16 base, rank 16 on the attention projections, remat,
    min-SNR) with the profiled replay held to the capture's launches by
    shape.  Last, the run's writes against its limit.  Returns the launches
    per step of each kernel at each of Kolors's attention shapes."""
    import gc

    import torch

    from simpletuner_tpu_torch.bench_cache import prompts_for
    from simpletuner_tpu_torch.inference import CheckpointInferenceRuntime, config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import unet_checkpoint_shapes, vae_checkpoint_shapes
    from simpletuner_tpu_torch.models.kolors import Kolors
    from simpletuner_tpu_torch.models.llm_encoder import LLMEncoderConfig
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.unet import UNet2DCondition, UNetConfig, make_sdxl_added_cond
    from simpletuner_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from simpletuner_tpu_torch.models.weight_import import save_safetensors, unet_params_from_diffusers

    start = time.perf_counter()
    work = paths["work"]
    shutil.rmtree(os.path.join(work, "flux2"), ignore_errors=True)  # phase 31's: disk space
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    tiny = dataclasses.replace(UNetConfig.tiny_xl(), cross_attention_dim=32, addition_embed_dim=6 * 8 + 32)
    wider = dataclasses.replace(tiny, block_out_channels=(32, 64, 64), transformer_layers=(1, 2, 3),
                                cross_attention_blocks=(True, True, True), cross_attention_dim=24,
                                addition_embed_dim=6 * 8 + 20)
    flop_checks = _flop_checks(sdxl_step_flops, UNet2DCondition, [
        (arch, (torch.zeros(2, h, w, 4), torch.full((2,), 10.0), torch.zeros(2, txt, arch.cross_attention_dim),
                make_sdxl_added_cond(torch.zeros(2, 6), torch.zeros(2, arch.addition_embed_dim - 48), 8)), (h, w, txt))
        for arch, (h, w), txt in ((tiny, (8, 8), 7), (wider, (8, 12), 5))])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(32)
    full = dataclasses.replace(UNetConfig.sdxl(), cross_attention_dim=4096, addition_embed_dim=6 * 256 + 4096)
    arch = dataclasses.replace(full, transformer_layers=layers)
    shapes = unet_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 6e9 or written_before + file_bytes / 1e9 + 1.0 > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"kolors: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the phase; "
                           f"it writes {file_bytes / 1e9 + 1.0:.1f} GB of the {RUN_WRITE_TARGET_GB} GB a run may write")

    # (b) the seeded UNet (two e4m3 shards in unet/), the ChatGLM trunk with
    # ChatGLM's config.json, a word-level tokenizer, the SDXL VAE
    k_dir = os.path.join(work, "kolors")
    weights, write_s = _write_e4m3_transformer(k_dir, shapes, gen, subfolder="unet")
    glm_full = LLMEncoderConfig.chatglm3_6b()
    if (glm_full.hidden_size, glm_full.num_layers, glm_full.num_heads, glm_full.num_kv_heads, glm_full.head_dim,
            glm_full.intermediate_size, glm_full.vocab_size, glm_full.fused_qkv, glm_full.qkv_bias,
            glm_full.partial_rotary, glm_full.rope_interleaved) != (4096, 28, 32, 2, 128, 13696, 65024, True, True,
                                                                     0.5, True):
        raise RuntimeError(f"not ChatGLM3-6B's trunk: {glm_full}")
    glm = dataclasses.replace(glm_full, num_layers=GLM_FILE_LAYERS)
    glm_dir = os.path.join(k_dir, "text_encoder")
    glm_write_s = write_llm_trunk(glm_dir, glm, gen, {})
    with open(os.path.join(glm_dir, "config.json"), "w") as handle:  # THUDM/chatglm3-6b's keys
        json.dump({"architectures": ["ChatGLMModel"], "model_type": "chatglm", "hidden_size": glm.hidden_size,
                   "ffn_hidden_size": glm.intermediate_size, "num_layers": glm.num_layers,
                   "num_attention_heads": glm.num_heads, "multi_query_attention": True,
                   "multi_query_group_num": glm.num_kv_heads, "kv_channels": glm.head_dim,
                   "layernorm_epsilon": glm.rms_eps, "padded_vocab_size": glm.vocab_size, "add_qkv_bias": True,
                   "add_bias_linear": False, "rmsnorm": True, "original_rope": True, "seq_length": 8192,
                   "torch_dtype": "float8_e4m3fn"}, handle)
    prompts = [f"{TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]}, {p}" for i, p in enumerate(prompts_for(TEXT_PROMPTS))]
    write_gemma_tokenizer(os.path.join(k_dir, "tokenizer"),
                          " ".join(TRAIN_CAPTIONS + [KOLORS_PROMPT] + prompts).split())
    sdxl_vae = os.path.join(work, "sdxl", "vae")
    if os.path.isdir(sdxl_vae):
        _link_tree(sdxl_vae, os.path.join(k_dir, "vae"))
    else:
        with torch.device(dev):
            vae = AutoencoderKL(VAEConfig.sdxl(), torch.bfloat16)
        os.makedirs(os.path.join(k_dir, "vae"))
        save_safetensors(seeded_weights(vae_checkpoint_shapes(vae), gen),
                         os.path.join(k_dir, "vae", "diffusion_pytorch_model.safetensors"))
        del vae
    files = {"unet_gb": file_bytes / 1e9, "unet_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "glm_layers": [GLM_FILE_LAYERS, glm_full.num_layers],
             "glm_write_s": glm_write_s, "vae": "phase 20's, linked" if os.path.isdir(sdxl_vae) else "seeded here",
             "written_gb_before": written_before, "written_gb_after": _written_gb(), "free_gb_before": free / 1e9}

    # (c) 256-token prompts through the ChatGLM encoder the trainer builds
    text = _llm_text_report(Kolors.TEXT_ENCODER_CONFIGURATION[0], k_dir, glm, KOLORS_TEXT, prompts)

    # (d) the import, bitwise
    model = ModelRegistry.create("kolors", config_namespace({"model_family": "kolors", "model_type": "full"}))
    if model.arch != arch:
        raise RuntimeError(f"kolors: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()
    imported = _import_bitwise(model, module, k_dir, weights, unet_params_from_diffusers, file_bytes)
    params = imported["params"]
    del weights, module
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the true-CFG DDIM render: every transformer block's self- and
    # cross-attention at its level's shape, two forwards a step
    levels = len(arch.block_out_channels)
    per_level = [arch.depth_at(level) * (2 * arch.layers_per_block + 1) + (arch.depth_at(level) if level == levels - 1
                                                                          else 0) for level in range(levels)]
    shape_keys = {}
    for level, (heads, seq) in enumerate(SDXL_LEVELS):
        shape_keys[f"kolors_l{level}_self"] = (f"{heads}x{seq}x{seq}x64", per_level[level])
        shape_keys[f"kolors_l{level}_cross"] = (f"{heads}x{seq}x{KOLORS_TEXT}x64", per_level[level])
    per_forward = sum(n for _, n in shape_keys.values())
    config_path = os.path.join(work, "kolors_render.json")
    with open(config_path, "w") as handle:
        json.dump({"model_family": "kolors", "model_type": "full", "pretrained_model_name_or_path": k_dir,
                   "mixed_precision": "bf16", "text_encoder_precision": "bf16", "vae_dtype": "bf16",
                   "validation_resolution": RESOLUTION, "validation_seed": 42, "seed": 42,
                   "validation_guidance": KOLORS_GUIDANCE}, handle)
    t0 = time.perf_counter()
    runtime = CheckpointInferenceRuntime(config_path=config_path, output=os.path.join(work, "kolors_render"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    timed = _timed_render(runtime, kernels, KOLORS_PROMPT, KOLORS_GUIDANCE)
    render = _render_report(timed, per_forward, KOLORS_GUIDANCE, init_s)
    if timed["launches_by_shape"]["flash_fwd"] != {key: 2 * STEPS * n for key, n in shape_keys.values()}:
        raise RuntimeError(f"kolors render: launches by shape {timed['launches_by_shape']}")
    module, model = runtime.module, runtime.model
    if model.arch != arch or model.NAME != "kolors" or model.is_flow:
        raise RuntimeError(f"kolors: the runtime built {model.NAME} {model.arch}")

    # (f) one UNet forward, kernels against the plain attention (the ChatGLM states unmasked)
    latent = RESOLUTION // 8
    batch = _text_batch(model, KOLORS_PROMPT, (1, latent, latent, 4), dev)
    collated = {k: tuple(v.shape) for k, v in batch.items()}
    if collated != {"latents": (1, latent, latent, 4), "text_embeds": (1, KOLORS_TEXT, 4096),
                    "pooled_embeds": (1, 4096)}:
        raise RuntimeError(f"kolors: the collated batch {collated}")
    model.text_encoders = []
    gc.collect()
    torch.cuda.empty_cache()
    noise = torch.randn((1, latent, latent, 4), generator=gen, device=dev)
    parity = {**_parity_forward(model, module, batch, noise, KOLORS_PARITY_T), "t": KOLORS_PARITY_T}
    parity.pop("sigma")
    del runtime, module, model, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (g) Trainer.run(): bf16 base, rank-16 LoRA on the attention projections,
    # remat, min-SNR epsilon, 6 graphed steps on four of phase 16's JPEGs
    def check(trainer) -> dict:
        batch = trainer._example_batch()
        conditioning = {k: tuple(v.shape) for k, v in batch.items() if "embeds" in k or "mask" in k}
        targets = {name.rsplit("/", 2)[-2] for name in trainer._state.trainable}
        if trainer.model.arch != arch or trainer.vae.config != VAEConfig.sdxl() or \
                conditioning != {"text_embeds": (1, KOLORS_TEXT, 4096), "pooled_embeds": (1, 4096)} or \
                targets != {"to_q", "to_k", "to_v", "to_out"}:
            raise RuntimeError(f"kolors trainer: arch {trainer.model.arch}, VAE {trainer.vae.config}, batch "
                               f"{conditioning}, adapters on {targets}")
        return {"vae": "VAEConfig.sdxl() (4 latent channels)", **_graph_matches_eager(trainer, ("loss", "grad_norm"))}

    data = _square_jpegs(work, "kolors_data", KOLORS_TRAIN_IMAGES)
    cache = os.path.join(work, "kolors_cache")
    config = _image_train_config("kolors", k_dir, data, cache, os.path.join(work, "kolors_train"),
                                 KOLORS_TRAIN_STEPS, lora_target_modules=["to_q", "to_k", "to_v", "to_out"],
                                 snr_gamma=SDXL_SNR_GAMMA)
    config.pop("base_model_precision")
    config.pop("quantized_matmul")
    expected = {"flash_fwd": 2 * per_forward, "flash_bwd_dq": per_forward, "flash_bwd_dkv": per_forward}
    flops = sdxl_step_flops(arch, 1, latent, latent, KOLORS_TEXT)
    train = _train_graphed(config, kernels, KOLORS_TRAIN_STEPS, expected, flops, check)
    by_shape = train["launches_per_step_by_shape"]
    if by_shape != {"flash_fwd": {key: 2 * n for key, n in shape_keys.values()},
                    "flash_bwd_dq": {key: n for key, n in shape_keys.values()},
                    "flash_bwd_dkv": {key: n for key, n in shape_keys.values()}}:
        raise RuntimeError(f"kolors trainer: launches per step by shape {by_shape}")
    train.update({"base": "bf16", "remat": "every resnet and spatial transformer", "lora_rank": 16,
                  "snr_gamma": SDXL_SNR_GAMMA, "flop_checks": flop_checks})
    shutil.rmtree(cache, ignore_errors=True)
    writes = check_run_writes()
    phase("32 kolors", config="Kwai-Kolors/Kolors-diffusers unet/ as the JAX family builds it (UNetConfig.sdxl() with "
          "cross_attention_dim 4096 and addition_embed_dim 5632)", params=params,
          channels=list(arch.block_out_channels), transformer_depths=[list(arch.transformer_layers),
                                                                      list(full.transformer_layers)],
          heads_of_64=[c // 64 for c in arch.block_out_channels],
          tokens={"text": KOLORS_TEXT, "image_per_level": [s for _, s in SDXL_LEVELS]},
          attention_per_forward=per_forward, files=files, text_encoder=text, imported=imported, render=render,
          parity=parity, train=train, allocated_gib_before_phase=baseline_gib,
          seconds=time.perf_counter() - start, device=device, **writes)
    return {name: {k: v.get(key) for k, v in by_shape.items()} for name, (key, _) in shape_keys.items()}


def longcat_image_step_flops(arch, batch: int, img_tokens: int, txt_tokens: int, tokenwise: bool = False) -> int:
    """Model FLOPs of one LongCat-Image train step in bench.py's convention
    (forward x 3), counted from the config (Flux's topology without the
    pooled and guidance embedders): ``img_in`` and ``txt_in``; the time MLP
    per sample, or per image token with ``tokenwise`` timesteps; per double
    block the two AdaLN modulations (the image one per image token when
    tokenwise, the text one per sample), q / k / v / out and the MLP over
    every token and the joint attention's two products; per single block its
    modulation (per token when tokenwise), ``linear1`` and ``linear2`` over
    every token and the attention; ``final_mod`` and the head."""
    h, c = arch.hidden_size, arch.in_channels
    mlp = int(h * arch.mlp_ratio)
    joint = img_tokens + txt_tokens
    img_rows, joint_rows = (img_tokens, joint) if tokenwise else (1, 1)
    fwd = 2 * img_tokens * c * h + 2 * txt_tokens * arch.txt_in_features * h + img_rows * 2 * (256 * h + h * h)
    fwd += arch.depth_double * (12 * h * h * (img_rows + 1) + joint * (8 * h * h + 4 * h * mlp) + 4 * joint * joint * h)
    fwd += arch.depth_single * (6 * h * h * joint_rows + joint * 4 * h * (2 * h + mlp) + 4 * joint * joint * h)
    fwd += img_rows * 4 * h * h + 2 * img_tokens * h * c
    return batch * fwd * 3


def z_image_omni_step_flops(arch, batch: int, img_tokens: int, cap_tokens: int, cond: bool = False,
                            siglip_tokens: int = 0) -> int:
    """Model FLOPs of one Z-Image-Omni train step in bench.py's convention
    (forward x 3), counted from the config: the time MLP twice per sample (the
    noisy and the clean embedding); the image (with ``cond``, twice the image
    tokens), caption and SigLIP embedders; per block q, k, v, out and the
    SwiGLU over its tokens and the attention's two products, the modulated
    blocks' scale-only adaLN twice per sample; the noise refiners over the
    image tokens, the context refiners over the caption, the SigLIP refiners
    over its tokens, the layers over the unified sequence; the final
    modulation per sample and the head over the noisy tokens."""
    h, inner, adaln = arch.hidden_size, arch.ffn_inner, arch.adaln_dim
    q, kv = arch.num_heads * arch.head_dim, arch.num_kv_heads * arch.head_dim
    packed = arch.patch_size ** 2 * arch.in_channels
    images = img_tokens * (2 if cond else 1)
    joint = cap_tokens + images + siglip_tokens

    def block(tokens: int, modulated: bool) -> int:
        mods = 2 * 2 * adaln * 4 * h if modulated else 0
        return mods + tokens * (2 * h * (2 * q + 2 * kv) + 6 * h * inner) + 4 * tokens * tokens * q

    fwd = 2 * 2 * (256 * arch.t_mid_size + arch.t_mid_size * adaln)
    fwd += 2 * h * (images * packed + cap_tokens * arch.cap_feat_dim + siglip_tokens * arch.siglip_feat_dim)
    fwd += arch.refiner_depth * (block(images, True) + block(cap_tokens, False) +
                                 (block(siglip_tokens, False) if siglip_tokens else 0))
    fwd += arch.depth * block(joint, True) + 2 * adaln * h + 2 * img_tokens * h * packed
    return batch * fwd * 3


def zlab_i1_step_flops(arch, batch: int, img_tokens: int, text_tokens: int) -> int:
    """Model FLOPs of one Zlab-i1 train step in bench.py's convention (forward
    x 3), counted from the config (no timestep input): the patch embed and
    the head over the image tokens; the connector's input linear and its two
    rounds of fused qkv, out, attention and SwiGLU over the text tokens; per
    U-ViT block the fused qkv, out and SwiGLU over every token and the joint
    attention's two products; the out blocks' skip linears."""
    h, inner = arch.hidden_size, arch.ffn_inner
    packed = arch.patch_size ** 2 * arch.in_channels
    joint = img_tokens + text_tokens

    def rounds(tokens: int) -> int:
        return tokens * (8 * h * h + 6 * h * inner) + 4 * tokens * tokens * h

    fwd = 4 * img_tokens * packed * h + 2 * text_tokens * arch.text_embed_dim * h + 2 * rounds(text_tokens)
    fwd += arch.depth * rounds(joint) + arch.num_in_blocks * joint * 4 * h * h
    return batch * fwd * 3


def _forward_launches(model, module, batch: dict, kernels, sigma: float) -> dict:
    """The wrappers' launches by shape over one forward of ``batch`` at ``sigma``."""
    import torch

    for kernel in kernels:
        kernel.launches = 0
        kernel.shape_launches.clear()
    with torch.no_grad():
        model.denoise_fn(module, model.inference_conditioning(batch))(torch.randn_like(batch["latents"]),
                                                                      torch.tensor(sigma))
    torch.cuda.synchronize()
    return _per_shape(kernels)


def _encoder_and_report(spec, root: str, config, tokens: int, prompts: list) -> tuple:
    """The decoder-LLM encoder the trainer builds from ``root`` (its load
    seconds) and ``_llm_text_report`` of ``prompts`` through it."""
    import torch

    from simpletuner_tpu_torch.models.text_encoders import load_text_encoders

    t0 = time.perf_counter()
    (encoder,) = load_text_encoders([spec], pretrained_path=root, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    return encoder, {**_llm_text_report(spec, None, config, tokens, prompts, encoder=encoder), "load_s": load_s}


def longcat_image_phase(paths: dict, kernels, device: str, depth: tuple) -> dict:
    """Phase 33: LongCat-Image at the JAX preset's full width and ``depth``
    (double, single) of its 19 + 38 blocks: a seeded e4m3 transformer in
    LongCat's layout beside the Qwen2.5-VL trunk (``qwen_trunk``, linked as
    ``text_encoder``), a word-level tokenizer and phase 14's Flux VAE: 16
    prompts through the trunk (prompts/s, bf16 against f32) and through
    ``LongcatImage.encode_text`` (the captioning template's spans sliced off);
    the import held bitwise; a 1024 px true-CFG flow Euler render; one forward
    with the kernels against the plain attention; 6 graphed LoRA steps through
    ``Trainer.run()`` on an int8 base; then the edit flavour on the same file:
    ``build_train_step`` graphed on seeded ``control_latents`` (tokenwise
    timesteps, the reference tokens at t = 0).  Returns the launches per step
    of each kernel at the two joint shapes."""
    import gc

    import numpy as np
    import torch

    from simpletuner_tpu_torch.bench_cache import prompts_for
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import longcat_image_checkpoint_shapes
    from simpletuner_tpu_torch.models.flux.transformer import FluxConfig, FluxTransformer
    from simpletuner_tpu_torch.models.layers import init_adapters
    from simpletuner_tpu_torch.models.longcat_image import LongcatImage
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.vae import VAEConfig
    from simpletuner_tpu_torch.models.weight_import import load_transformer_params, longcat_image_params_from_diffusers

    start = time.perf_counter()
    work, flux_dir = paths["work"], paths["flux_dir"]
    for out in ("kolors", "kolors_data", "kolors_train", "kolors_render"):  # phase 32's: disk space
        shutil.rmtree(os.path.join(work, out), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    tiny = dataclasses.replace(FluxConfig.tiny(), vector_embed=False, guidance_embed=False)
    narrow = dataclasses.replace(tiny, hidden_size=48, num_heads=3, head_dim=16, depth_double=1, depth_single=2,
                                 mlp_ratio=2.0, txt_in_features=20, axes_dim=(4, 6, 6))
    flop_checks = _flop_checks(longcat_image_step_flops, FluxTransformer, [
        (arch, (torch.zeros(2, img, arch.in_channels), torch.zeros(2, img, 3),
                torch.zeros(2, txt, arch.txt_in_features), torch.zeros(2, txt, 3),
                torch.full((2, img) if tokenwise else (2,), 0.5), None), (img, txt, tokenwise))
        for arch, img, txt, tokenwise in ((tiny, 12, 5, False), (narrow, 10, 3, True))])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(33)
    full = FluxConfig(in_channels=64, hidden_size=3072, num_heads=24, head_dim=128, depth_double=19, depth_single=38,
                      txt_in_features=3584, vec_in_features=3584, vector_embed=False, guidance_embed=False)
    arch = dataclasses.replace(full, depth_double=depth[0], depth_single=depth[1])
    shapes = longcat_image_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 6e9 or written_before + file_bytes / 1e9 + 0.2 + _reserved(33) > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"longcat_image: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the "
                           f"phase; it and the later phases write {file_bytes / 1e9 + 0.2 + _reserved(33):.1f} GB of "
                           f"the {RUN_WRITE_TARGET_GB} GB a run may write")

    # (b) the seeded files: the transformer (two e4m3 shards), the Qwen trunk
    # and phase 14's Flux VAE linked, a word-level tokenizer in tokenizer/
    lc_dir = os.path.join(work, "longcat_image")
    weights, write_s = _write_e4m3_transformer(lc_dir, shapes, gen)
    qwen = qwen_trunk(paths, 33)
    _link_tree(os.path.join(qwen["root"], "text_encoder"), os.path.join(lc_dir, "text_encoder"))
    _link_tree(os.path.join(flux_dir, "vae"), os.path.join(lc_dir, "vae"))
    prompts = [f"{TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]}, {p}" for i, p in enumerate(prompts_for(TEXT_PROMPTS))]
    write_gemma_tokenizer(os.path.join(lc_dir, "tokenizer"), " ".join(TRAIN_CAPTIONS + [LC_PROMPT] + prompts).split())
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9,
             "qwen": {"written_by_phase": qwen["written_by_phase"], "layers": qwen["layers"]},
             "written_gb_before": written_before, "written_gb_after": _written_gb(), "free_gb_before": free / 1e9}

    # (c) the prompts through the Qwen2.5-VL encoder the trainer builds, then
    # through the family's template: its prefix and suffix spans sliced off
    spec = LongcatImage.TEXT_ENCODER_CONFIGURATION[0]
    encoder, text = _encoder_and_report(spec, lc_dir, qwen["config"], spec.max_length, prompts)
    values = {"model_family": "longcat_image", "model_type": "full"}
    templated = LongcatImage(config_namespace({**values, "mixed_precision": "bf16"}))
    templated.attach_text_encoders([encoder])
    templated.encode_text(prompts[:2])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payloads = templated.encode_text(prompts)
    template_s = time.perf_counter() - t0
    states = np.stack([p["t5_embeds"] for p in payloads])
    valid = np.stack([p["attention_mask"] for p in payloads]).sum(axis=1)
    if states.shape != (TEXT_PROMPTS, LC_TEXT, 3584) or not np.isfinite(states).all() or \
            not ((0 < valid) & (valid < LC_TEXT)).all():
        raise RuntimeError(f"longcat_image text: {states.shape} (the template's spans should leave {LC_TEXT}), "
                           f"valid tokens {valid.tolist()}")
    text.update({"template_tokens": LC_TEXT, "template_encode_s": template_s,
                 "template_prompts_per_s": TEXT_PROMPTS / template_s, "template_valid": [int(valid.min()),
                                                                                           int(valid.max())]})
    latent = RESOLUTION // 8
    batch = _text_batch(templated, LC_PROMPT, (1, latent, latent, 16), dev)
    if {k: tuple(v.shape) for k, v in batch.items()} != {"latents": (1, latent, latent, 16),
                                                         "t5_embeds": (1, LC_TEXT, 3584)}:
        raise RuntimeError(f"longcat_image: the collated batch {({k: tuple(v.shape) for k, v in batch.items()})}")
    del encoder, templated, states
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the import, bitwise
    model = ModelRegistry.create("longcat_image", config_namespace(values))
    if model.arch != arch:
        raise RuntimeError(f"longcat_image: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()
    imported = _import_bitwise(model, module, lc_dir, weights, longcat_image_params_from_diffusers, file_bytes)
    params = imported["params"]
    del weights, module
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the true-CFG render at the sliding ids and (f) the parity forward
    per_forward = depth[0] + depth[1]
    joint_key = f"24x{LC_JOINT}x{LC_JOINT}x128"
    render, runtime = _image_render(work, "longcat_image", lc_dir, "lc", kernels, LC_PROMPT, LC_GUIDANCE,
                                    {joint_key: per_forward})
    module, model = runtime.module, runtime.model
    if model.arch != arch or model.NAME != "longcat_image" or not model.is_flow or model.arch.guidance_embed:
        raise RuntimeError(f"longcat_image: the runtime built {model.NAME} {model.arch}")
    model.text_encoders = []
    gc.collect()
    torch.cuda.empty_cache()
    noise = torch.randn((1, latent, latent, 16), generator=gen, device=dev)
    parity = {**_parity_forward(model, module, batch, noise, LC_SIGMA), "tokens": LC_JOINT}
    del runtime, module, model
    gc.collect()
    torch.cuda.empty_cache()

    # (g) Trainer.run(): int8 base, the JAX family's Flux preset "all", 6 graphed steps
    def check(trainer) -> dict:
        example = trainer._example_batch()
        conditioning = {k: tuple(v.shape) for k, v in example.items() if "embeds" in k or "mask" in k}
        if trainer.model.arch != arch or trainer.vae.config != VAEConfig.flux() or \
                trainer.model.base_precision != "int8" or conditioning != {"t5_embeds": (1, LC_TEXT, 3584)}:
            raise RuntimeError(f"longcat_image trainer: arch {trainer.model.arch}, VAE {trainer.vae.config}, base "
                               f"{trainer.model.base_precision}, batch {conditioning}")
        return {"vae": "VAEConfig.flux() (16 latent channels)", **_graph_matches_eager(trainer, ("loss", "grad_norm"))}

    data = _square_jpegs(work, "lc_data", LC_TRAIN_IMAGES)
    cache = os.path.join(work, "lc_cache")
    config = _image_train_config("longcat_image", lc_dir, data, cache, os.path.join(work, "lc_train"), LC_TRAIN_STEPS)
    expected = {"flash_fwd": 2 * per_forward, "flash_bwd_dq": per_forward, "flash_bwd_dkv": per_forward}
    train = _train_graphed(config, kernels, LC_TRAIN_STEPS, expected,
                           longcat_image_step_flops(arch, 1, LC_IMG, LC_TEXT), check)
    by_shape = train["launches_per_step_by_shape"]
    if any(by_shape[k] != {joint_key: n} for k, n in expected.items()):
        raise RuntimeError(f"longcat_image trainer: launches per step by shape {by_shape}")
    train.update({"base": "int8", "quantized_matmul": "full", "remat": "every block", "lora_rank": 16,
                  "flop_checks": flop_checks})
    shutil.rmtree(cache, ignore_errors=True)

    # (h) the edit flavour: 4,096 reference tokens at modality 2 and t = 0
    # (tokenwise timesteps), build_train_step graphed on seeded control latents
    edit_values = {**_graph_train_values("longcat_image", LC_TRAIN_STEPS), "model_flavour": "edit"}
    edit_model = LongcatImage(config_namespace(edit_values))
    if edit_model.arch != arch or not edit_model.is_kontext:
        raise RuntimeError(f"longcat_image edit: the family builds {edit_model.arch}")
    with torch.device(dev):
        edit_module = load_transformer_params(edit_model, init_adapters(edit_model.create_module(), gen), lc_dir)
    edit_batch = {**batch, "latents": torch.randn((1, latent, latent, 16), generator=gen, device=dev),
                  "control_latents": torch.randn((1, latent, latent, 16), generator=gen, device=dev)}
    edit_key = f"24x{LC_EDIT_JOINT}x{LC_EDIT_JOINT}x128"
    edit = _graph_vs_eager(edit_model, edit_module, edit_batch, kernels, LC_TRAIN_STEPS, expected,
                           longcat_image_step_flops(arch, 1, 2 * LC_IMG, LC_TEXT, tokenwise=True))
    edit_by_shape = edit["launches_per_step_by_shape"]
    if any(edit_by_shape[k] != {edit_key: n} for k, n in expected.items()):
        raise RuntimeError(f"longcat_image edit: launches per step by shape {edit_by_shape}")
    edit.update({"base": "int8", "quantized_matmul": "full", "remat": "every block", "lora_rank": 16,
                 "tokens": {"text": LC_TEXT, "image": LC_IMG, "reference": LC_IMG, "joint": LC_EDIT_JOINT}})
    del edit_module, edit_model, edit_batch, batch
    gc.collect()
    torch.cuda.empty_cache()
    phase("33 longcat_image", config="meituan-longcat/LongCat-Image transformer/ as the JAX family builds it (Flux "
          "topology, no pooled or guidance embedder)", params=params, hidden=arch.hidden_size,
          heads=[arch.num_heads, arch.head_dim], depth=[[arch.depth_double, arch.depth_single],
                                                        [full.depth_double, full.depth_single]],
          tokens={"image": LC_IMG, "text": LC_TEXT, "joint": LC_JOINT}, files=files, text_encoder=text,
          imported=imported, render=render, parity=parity, train=train, edit=edit,
          allocated_gib_before_phase=baseline_gib, seconds=time.perf_counter() - start, device=device)
    return {"lc_joint": {k: v.get(joint_key) for k, v in by_shape.items()},
            "lc_edit_joint": {k: v.get(edit_key) for k, v in edit_by_shape.items()}}


def _graph_train_values(family: str, steps: int) -> dict:
    """``build_train_step``'s config for a family built in memory: rank-16
    LoRA on an int8 base (``quantized_matmul: full``), every block
    checkpointed, AdamW 1e-4, bf16, as ``_image_train_config``."""
    return {"model_family": family, "model_type": "lora", "lora_rank": 16, "base_model_precision": "int8-quanto",
            "quantized_matmul": "full", "gradient_checkpointing": True, "optimizer": "adamw", "learning_rate": 1e-4,
            "lr_scheduler": "constant", "max_train_steps": steps, "mixed_precision": "bf16", "seed": 42}


def z_image_omni_phase(paths: dict, kernels, device: str, depth: tuple) -> dict:
    """Phase 34: Z-Image-Omni at the JAX preset's full width and ``depth``
    (layers of 30, refiner depth of 2): a seeded e4m3 transformer (the
    ``"2-1"`` patch keys and the SigLIP modules) beside phase 29's 2560-wide
    qwen2 trunk (linked; written here in a run without phase 29), a
    word-level tokenizer and phase 14's Flux VAE: 16 prompts at 512 tokens
    (prompts/s, bf16 against f32); the import held bitwise; a 1024 px
    true-CFG render, text to image; 6 graphed LoRA steps through
    ``Trainer.run()`` on an int8 base, text to image; one forward with
    seeded ``control_latents`` and ``siglip_embeds`` (each token's noisy or
    clean modulation) against the plain attention.  Then Boogu-Image built
    through the registry by name at ``BOOGU_BLOCKS`` of its 26 blocks in
    memory: one forward against the plain attention.  Returns the launches
    per step (the omni forward's per forward) of each kernel at its shapes."""
    import gc

    import torch

    from simpletuner_tpu_torch.bench_cache import prompts_for
    from simpletuner_tpu_torch.inference import CheckpointInferenceRuntime, config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import z_image_omni_checkpoint_shapes
    from simpletuner_tpu_torch.models.extended import BooguImage
    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.lumina2 import Lumina2, Lumina2Config
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.vae import VAEConfig
    from simpletuner_tpu_torch.models.weight_import import z_image_omni_params_from_diffusers
    from simpletuner_tpu_torch.models.z_image_omni import ZImageOmni, ZImageOmniConfig, ZImageOmniTransformer

    start = time.perf_counter()
    work, flux_dir = paths["work"], paths["flux_dir"]
    for out in ("longcat_image", "lc_data", "lc_train", "lc_render"):  # phase 33's: disk space
        shutil.rmtree(os.path.join(work, out), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    tiny = ZImageOmniConfig.tiny()
    narrow = dataclasses.replace(tiny, hidden_size=48, num_heads=2, num_kv_heads=1, depth=1, refiner_depth=2,
                                 cap_feat_dim=20, siglip_feat_dim=12, t_mid_size=32, axes_dim=(8, 8, 8))
    flop_checks = _flop_checks(z_image_omni_step_flops, ZImageOmniTransformer, [
        (tiny, (torch.zeros(2, 8, 6, 4), torch.full((2,), 0.5), torch.zeros(2, 7, 32)), (12, 7)),
        (narrow, (torch.zeros(2, 4, 8, 4), torch.full((2,), 0.5), torch.zeros(2, 5, 20), None,
                  torch.zeros(2, 2, 3, 12), torch.zeros(2, 4, 8, 4)), (8, 5, True, 6))])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(34)
    full = ZImageOmniConfig()
    if (full.hidden_size, full.num_heads, full.head_dim, full.depth, full.refiner_depth, full.cap_feat_dim,
            full.siglip_feat_dim, full.rope_theta, full.axes_dim, full.adaln_dim) != \
            (3840, 30, 128, 30, 2, 2560, 1152, 256.0, (32, 48, 48), 256):
        raise RuntimeError(f"not the JAX preset of Z-Image-Omni: {full}")
    arch = dataclasses.replace(full, depth=depth[0], refiner_depth=depth[1])
    shapes = z_image_omni_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 6e9 or written_before + file_bytes / 1e9 + 0.2 + _reserved(34) > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"z_image_omni: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the "
                           f"phase; it and the later phases write {file_bytes / 1e9 + 0.2 + _reserved(34):.1f} GB of "
                           f"the {RUN_WRITE_TARGET_GB} GB a run may write")

    # (b) the seeded files: the transformer (two e4m3 shards), phase 29's
    # 2560-wide qwen2 trunk and phase 14's Flux VAE linked, the tokenizer
    zo_dir = os.path.join(work, "z_image_omni")
    weights, write_s = _write_e4m3_transformer(zo_dir, shapes, gen)
    trunk = zi_trunk_config()
    trunk_source = paths.get("zi_trunk")
    if trunk_source and os.path.isdir(trunk_source):
        _link_tree(trunk_source, os.path.join(zo_dir, "text_encoder"))
        trunk_files = {"written_by_phase": 29, "layers": [ZI_TRUNK_LAYERS, 36]}
    else:
        trunk_files = {"written_by_phase": 34, "layers": [ZI_TRUNK_LAYERS, 36], "write_s": write_llm_trunk(
            os.path.join(zo_dir, "text_encoder"), trunk, gen, QWEN3_HF)}
    _link_tree(os.path.join(flux_dir, "vae"), os.path.join(zo_dir, "vae"))
    prompts = [f"{TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]}, {p}" for i, p in enumerate(prompts_for(TEXT_PROMPTS))]
    write_gemma_tokenizer(os.path.join(zo_dir, "tokenizer"), " ".join(TRAIN_CAPTIONS + [ZO_PROMPT] + prompts).split())
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "qwen2_trunk": trunk_files,
             "written_gb_before": written_before, "written_gb_after": _written_gb(), "free_gb_before": free / 1e9}

    # (c) the prompts at 512 tokens through the qwen2.5 spec's encoder
    _, text = _encoder_and_report(ZImageOmni.TEXT_ENCODER_CONFIGURATION[0], zo_dir, trunk, ZO_TEXT, prompts)
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the import, bitwise
    model = ModelRegistry.create("z_image_omni", config_namespace({"model_family": "z_image_omni",
                                                                  "model_type": "full"}))
    if model.arch != arch:
        raise RuntimeError(f"z_image_omni: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()
    imported = _import_bitwise(model, module, zo_dir, weights, z_image_omni_params_from_diffusers, file_bytes)
    params = imported["params"]
    del weights, module
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the true-CFG render, text to image: per forward the noise refiners
    # over the image, the context refiners over the caption, the layers over both
    keys = {"zo_noise_refiner": (f"30x{LC_IMG}x{LC_IMG}x128", depth[1]),
            "zo_context_refiner": (f"30x{ZO_TEXT}x{ZO_TEXT}x128", depth[1]),
            "zo_joint": (f"30x{ZO_JOINT}x{ZO_JOINT}x128", depth[0])}
    per_forward = sum(n for _, n in keys.values())
    config_path = os.path.join(work, "zo_render.json")
    with open(config_path, "w") as handle:
        json.dump({"model_family": "z_image_omni", "model_type": "full", "pretrained_model_name_or_path": zo_dir,
                   "mixed_precision": "bf16", "text_encoder_precision": "bf16", "vae_dtype": "bf16",
                   "validation_resolution": RESOLUTION,
                   "validation_seed": 42, "seed": 42, "validation_guidance": ZO_GUIDANCE}, handle)
    t0 = time.perf_counter()
    runtime = CheckpointInferenceRuntime(config_path=config_path, output=os.path.join(work, "zo_render"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    timed = _timed_render(runtime, kernels, ZO_PROMPT, ZO_GUIDANCE)
    render = _render_report(timed, per_forward, ZO_GUIDANCE, init_s)
    if timed["launches_by_shape"]["flash_fwd"] != {key: 2 * STEPS * n for key, n in keys.values()}:
        raise RuntimeError(f"z_image_omni render: launches by shape {timed['launches_by_shape']}")
    module, model = runtime.module, runtime.model
    if model.arch != arch or model.NAME != "z_image_omni" or not model.is_flow:
        raise RuntimeError(f"z_image_omni: the runtime built {model.NAME} {model.arch}")
    latent = RESOLUTION // 8
    batch = _text_batch(model, ZO_PROMPT, (1, latent, latent, 16), dev)
    if {k: tuple(v.shape) for k, v in batch.items()} != {"latents": (1, latent, latent, 16),
                                                         "text_embeds": (1, ZO_TEXT, 2560),
                                                         "text_attention_mask": (1, ZO_TEXT)}:
        raise RuntimeError(f"z_image_omni: the collated batch {({k: tuple(v.shape) for k, v in batch.items()})}")
    model.text_encoders = []

    # (f) the omni forward: a clean reference image and SigLIP features, each
    # token's modulation the noisy or the clean one, kernels against the plain attention
    omni = {**batch, "control_latents": torch.randn((1, latent, latent, 16), generator=gen, device=dev),
            "siglip_embeds": torch.randn((1, *ZO_SIGLIP, full.siglip_feat_dim), generator=gen, device=dev)}
    siglip_tokens = ZO_SIGLIP[0] * ZO_SIGLIP[1]
    omni_keys = {f"30x{2 * LC_IMG}x{2 * LC_IMG}x128": depth[1], f"30x{ZO_TEXT}x{ZO_TEXT}x128": depth[1],
                 f"30x{siglip_tokens}x{siglip_tokens}x128": depth[1],
                 f"30x{ZO_OMNI_JOINT}x{ZO_OMNI_JOINT}x128": depth[0]}
    omni_launches = _forward_launches(model, module, omni, kernels, ZO_SIGMA)
    if omni_launches["flash_fwd"] != omni_keys:
        raise RuntimeError(f"z_image_omni omni forward: launches by shape {omni_launches}")
    noise = torch.randn((1, latent, latent, 16), generator=gen, device=dev)
    omni_parity = {**_parity_forward(model, module, omni, noise, ZO_SIGMA), "launches_by_shape": omni_launches,
                   "tokens": {"caption": ZO_TEXT, "reference": LC_IMG, "image": LC_IMG, "siglip": siglip_tokens,
                              "joint": ZO_OMNI_JOINT}}
    del runtime, module, model, omni
    gc.collect()
    torch.cuda.empty_cache()

    # (g) Trainer.run(): int8 base, every adapter-carrying linear (the JAX
    # family's default), 6 graphed steps on four of phase 16's JPEGs, text to image
    def check(trainer) -> dict:
        example = trainer._example_batch()
        conditioning = {k: tuple(v.shape) for k, v in example.items() if "embeds" in k or "mask" in k}
        if trainer.model.arch != arch or trainer.vae.config != VAEConfig.flux() or \
                trainer.model.base_precision != "int8" or \
                conditioning != {"text_embeds": (1, ZO_TEXT, 2560), "text_attention_mask": (1, ZO_TEXT)}:
            raise RuntimeError(f"z_image_omni trainer: arch {trainer.model.arch}, VAE {trainer.vae.config}, base "
                               f"{trainer.model.base_precision}, batch {conditioning}")
        return {"vae": "VAEConfig.flux() (16 latent channels)", "caption_valid": int(
            example["text_attention_mask"].sum()), **_graph_matches_eager(trainer, ("loss", "grad_norm"))}

    data = _square_jpegs(work, "zo_data", ZO_TRAIN_IMAGES)
    cache = os.path.join(work, "zo_cache")
    config = _image_train_config("z_image_omni", zo_dir, data, cache, os.path.join(work, "zo_train"), ZO_TRAIN_STEPS)
    expected = {"flash_fwd": 2 * per_forward, "flash_bwd_dq": per_forward, "flash_bwd_dkv": per_forward}
    train = _train_graphed(config, kernels, ZO_TRAIN_STEPS, expected,
                           z_image_omni_step_flops(arch, 1, LC_IMG, ZO_TEXT), check)
    by_shape = train["launches_per_step_by_shape"]
    if by_shape != {"flash_fwd": {key: 2 * n for key, n in keys.values()},
                    "flash_bwd_dq": {key: n for key, n in keys.values()},
                    "flash_bwd_dkv": {key: n for key, n in keys.values()}}:
        raise RuntimeError(f"z_image_omni trainer: launches per step by shape {by_shape}")
    train.update({"base": "int8", "quantized_matmul": "full", "remat": "every block", "lora_rank": 16,
                  "flop_checks": flop_checks})
    shutil.rmtree(cache, ignore_errors=True)

    # (h) Boogu-Image by name through the registry: Lumina2's layout at
    # BOOGU_BLOCKS of its 26 blocks in memory, one forward against the plain attention
    lumina = Lumina2Config()
    with family_depth(BooguImage, depth=BOOGU_BLOCKS):
        boogu = ModelRegistry.create("boogu_image", config_namespace({
            "model_family": "boogu_image", "model_type": "full", "mixed_precision": "bf16"}))
    if type(boogu) is not BooguImage or not isinstance(boogu, Lumina2) or \
            boogu.arch != dataclasses.replace(lumina, depth=BOOGU_BLOCKS):
        raise RuntimeError(f"boogu_image: the registry built {type(boogu).__name__} {boogu.arch}")
    with torch.device(dev):
        boogu_module = init_parameters(boogu.create_module(), gen)
    boogu_batch = {"latents": torch.zeros((1, latent, latent, 16), device=dev),
                   "text_embeds": torch.randn((1, LUMINA_CAP, lumina.cap_feat_dim), generator=gen, device=dev),
                   "text_attention_mask": (torch.arange(LUMINA_CAP, device=dev) < LUMINA_VALID).to(torch.int32)[None]}
    boogu_keys = {f"24x{LUMINA_CAP}x{LUMINA_CAP}x96": lumina.refiner_depth,
                  f"24x{LUMINA_IMG}x{LUMINA_IMG}x96": lumina.refiner_depth,
                  f"24x{LUMINA_S}x{LUMINA_S}x96": BOOGU_BLOCKS}
    boogu_launches = _forward_launches(boogu, boogu_module, boogu_batch, kernels, ZO_SIGMA)
    if boogu_launches["flash_fwd"] != boogu_keys:
        raise RuntimeError(f"boogu_image forward: launches by shape {boogu_launches}")
    boogu_parity = {**_parity_forward(boogu, boogu_module, boogu_batch, torch.randn(
        (1, latent, latent, 16), generator=gen, device=dev), ZO_SIGMA), "launches_by_shape": boogu_launches}
    del boogu_module, boogu_batch, batch
    gc.collect()
    torch.cuda.empty_cache()
    phase("34 z_image_omni", config="Tongyi-MAI/Z-Image-Omni transformer/ as the JAX preset ZImageOmniConfig() "
          "builds it", params=params, hidden=arch.hidden_size, heads=[arch.num_heads, arch.head_dim],
          depth={"layers": [arch.depth, full.depth], "refiners": [arch.refiner_depth, full.refiner_depth]},
          tokens={"caption": ZO_TEXT, "image": LC_IMG, "joint": ZO_JOINT}, files=files, text_encoder=text,
          imported=imported, render=render, train=train, omni=omni_parity,
          boogu_image={"config": "boogu/boogu-image-v0.1 as the JAX family builds it (Lumina2Config())",
                       "depth": [BOOGU_BLOCKS, lumina.depth], "built": "registry by name, seeded in memory",
                       "parity": boogu_parity},
          allocated_gib_before_phase=baseline_gib, seconds=time.perf_counter() - start, device=device)
    out = {name: {k: v.get(key) for k, v in by_shape.items()} for name, (key, _) in keys.items()}
    out["zo_omni_joint"] = {"flash_fwd": depth[0], "flash_bwd_dq": 0, "flash_bwd_dkv": 0}  # per omni forward
    return out


def zlab_i1_phase(paths: dict, kernels, device: str, depth: int) -> dict:
    """Phase 35: Zlab-i1 at the JAX preset's full width: a seeded e4m3
    checkpoint at ``ZL_FILE_BLOCKS`` of its 29 blocks (norm scales drawn
    about 1) imported bitwise; a seeded Gemma-2 2B at ``GEMMA_ZL_LAYERS`` of
    its 26 layers in memory with a word-level tokenizer: 16 prompts at 256
    tokens (prompts/s, bf16 against f32); ``depth`` of the 29 blocks built in
    memory (``ZL_MEMORY_BLOCKS`` in a run of every phase, all 29 in a run
    that names the phase): one forward against the plain attention (the text masked as key ids), the
    flow Euler loop without a decode (no VAE of either package decodes
    FLUX.2's 32 channels), and ``build_train_step`` graphed on seeded
    32-channel latents (the FLUX.2 statistics normalize them): the replays
    held to the eager steps, s/step, MFU, peak GiB, the profiled replay's
    launches.  Returns the
    launches per step of each kernel at the joint and connector shapes."""
    import gc

    import torch

    from simpletuner_tpu_torch.bench_cache import prompts_for
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import zlab_i1_checkpoint_shapes
    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.llm_encoder import LLMEncoder, LLMEncoderConfig
    from simpletuner_tpu_torch.models.text_encoders import LLMTextEncoder, _tokenizer
    from simpletuner_tpu_torch.models.weight_import import zlab_i1_params_from_checkpoint
    from simpletuner_tpu_torch.models.zlab_i1 import ZlabI1, ZlabI1Config, ZlabI1Transformer
    from simpletuner_tpu_torch.schedulers.sampling import sample_loop
    from simpletuner_tpu_torch.training.validation import build_scheduler

    start = time.perf_counter()
    work = paths["work"]
    for out in ("z_image_omni", "zo_data", "zo_train", "zo_render"):  # phase 34's: disk space
        shutil.rmtree(os.path.join(work, out), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    tiny = ZlabI1Config.tiny()
    narrow = dataclasses.replace(tiny, hidden_size=48, num_heads=2, depth=5, text_embed_dim=20, in_channels=4)
    flop_checks = _flop_checks(zlab_i1_step_flops, ZlabI1Transformer, [
        (tiny, (torch.zeros(2, 16, 16, 8), torch.full((2,), 0.5), torch.zeros(2, 12, 32)), (64, 12)),
        (narrow, (torch.zeros(2, 8, 12, 4), torch.full((2,), 0.5), torch.zeros(2, 7, 20)), (24, 7))])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(35)
    full = ZlabI1Config()
    if (full.hidden_size, full.num_heads, full.head_dim, full.depth, full.in_channels, full.text_embed_dim,
            full.text_num_tokens, full.axes_dims, full.input_size) != (2016, 28, 72, 29, 32, 2304, 256, (36, 18, 18),
                                                                        128):
        raise RuntimeError(f"not the JAX preset of Zlab-i1: {full}")
    cut = dataclasses.replace(full, depth=ZL_FILE_BLOCKS)
    shapes = zlab_i1_checkpoint_shapes(cut)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 6e9 or written_before + file_bytes / 1e9 + 0.1 > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"zlab_i1: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the "
                           f"phase; it writes {file_bytes / 1e9 + 0.1:.1f} GB of the {RUN_WRITE_TARGET_GB} GB a run "
                           "may write")

    # (b) the seeded checkpoint (two e4m3 shards; the RMSNorm scales, ``.scale``
    # leaves, drawn about 1) and its import, bitwise
    zl_dir = os.path.join(work, "zlab_i1")
    weights = seeded_weights(shapes, gen)
    for name in [n for n in weights if n.endswith(".scale")]:
        weights[name] = (1.0 + 0.1 * torch.randn(shapes[name], generator=gen, device=dev)).to(torch.bfloat16)
    weights, write_s = _write_e4m3_transformer(zl_dir, shapes, gen, weights=weights)
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "blocks": [ZL_FILE_BLOCKS, full.depth],
             "written_gb_before": written_before, "written_gb_after": _written_gb(), "free_gb_before": free / 1e9}
    with family_depth(ZlabI1, depth=ZL_FILE_BLOCKS):
        cut_model = ZlabI1(config_namespace({"model_family": "zlab_i1", "model_type": "full"}))
    if cut_model.arch != cut:
        raise RuntimeError(f"zlab_i1: the family builds {cut_model.arch}, not {cut}")
    with torch.device(dev):
        module = cut_model.create_module()
    imported = _import_bitwise(cut_model, module, zl_dir, weights, zlab_i1_params_from_checkpoint, file_bytes)
    del weights, module, cut_model
    gc.collect()
    torch.cuda.empty_cache()

    # (c) Gemma-2 2B at GEMMA_ZL_LAYERS of 26 in memory, 256-token prompts
    gemma_full = LLMEncoderConfig.gemma2_2b()
    gemma = dataclasses.replace(gemma_full, num_layers=GEMMA_ZL_LAYERS)
    prompts = [f"{TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]}, {p}" for i, p in enumerate(prompts_for(TEXT_PROMPTS))]
    write_gemma_tokenizer(os.path.join(zl_dir, "tokenizer"), " ".join(TRAIN_CAPTIONS + [ZL_PROMPT] + prompts).split())
    spec = ZlabI1.TEXT_ENCODER_CONFIGURATION[0]
    t0 = time.perf_counter()
    with torch.device(dev):
        trunk = LLMEncoder(gemma)
    trunk.reset_parameters(torch.Generator(device=dev).manual_seed(350))
    encoder = LLMTextEncoder(spec, trunk.eval(), _tokenizer("AutoTokenizer", zl_dir, "tokenizer"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    text = {**_llm_text_report(spec, None, gemma, ZL_TEXT, prompts, encoder=encoder),
            "layers": [GEMMA_ZL_LAYERS, gemma_full.num_layers], "built_in_memory_s": build_s}

    # (d) ``depth`` blocks in memory: a forward against the plain attention and the Euler loop
    mem = dataclasses.replace(full, depth=depth)
    model = ZlabI1(config_namespace(_graph_train_values("zlab_i1", ZL_TRAIN_STEPS)), arch=mem)
    model.attach_text_encoders([encoder])
    latent = RESOLUTION // 8
    batch = _text_batch(model, ZL_PROMPT, (1, latent, latent, 32), dev)
    if {k: tuple(v.shape) for k, v in batch.items()} != {"latents": (1, latent, latent, 32),
                                                         "text_embeds": (1, ZL_TEXT, 2304),
                                                         "text_attention_mask": (1, ZL_TEXT)}:
        raise RuntimeError(f"zlab_i1: the collated batch {({k: tuple(v.shape) for k, v in batch.items()})}")
    model.text_encoders = []
    del encoder, trunk
    gc.collect()
    torch.cuda.empty_cache()
    with torch.device(dev):
        module = init_parameters(model.create_module(), torch.Generator(device=dev).manual_seed(42))
    joint_key, connector_key = f"28x{ZL_JOINT}x{ZL_JOINT}x72", f"28x{ZL_TEXT}x{ZL_TEXT}x72"
    launches = _forward_launches(model, module, batch, kernels, ZL_SIGMA)
    if launches["flash_fwd"] != {joint_key: mem.depth, connector_key: 2}:
        raise RuntimeError(f"zlab_i1 forward: launches by shape {launches}")
    noise = torch.randn((1, latent, latent, 32), generator=gen, device=dev)
    parity = {**_parity_forward(model, module, batch, noise, ZL_SIGMA), "tokens": ZL_JOINT,
              "text_valid": int(batch["text_attention_mask"].sum()), "launches_by_shape": launches}
    forward_s = []

    def before(mod, args, kwargs):
        torch.cuda.synchronize()
        forward_s.append(-time.perf_counter())

    def after(mod, args, kwargs, out):
        torch.cuda.synchronize()
        forward_s[-1] += time.perf_counter()

    hooks = [module.register_forward_pre_hook(before, with_kwargs=True),
             module.register_forward_hook(after, with_kwargs=True)]
    for kernel in kernels:
        kernel.launches = 0
        kernel.shape_launches.clear()
    try:
        t0 = time.perf_counter()
        with torch.no_grad():
            latents = sample_loop(build_scheduler(model, STEPS), model.denoise_fn(module, model.inference_conditioning(
                batch)), torch.randn((1, latent, latent, 32), generator=gen, device=dev))
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    finally:
        for hook in hooks:
            hook.remove()
    loop_launches = {kernel.name: kernel.launches for kernel in kernels}
    if loop_launches != {"flash_fwd": STEPS * (mem.depth + 2), "flash_bwd_dq": 0, "flash_bwd_dkv": 0} or \
            len(forward_s) != STEPS or tuple(latents.shape) != (1, latent, latent, 32) or \
            not torch.isfinite(latents).all():
        raise RuntimeError(f"zlab_i1 sampler: launches {loop_launches}, {len(forward_s)} forwards, latents "
                           f"{tuple(latents.shape)} finite {bool(torch.isfinite(latents).all())}")
    sampler = {"steps": STEPS, "loop_s": loop_s, "forward_s": forward_s,
               "s_per_euler_step": sum(forward_s[1:]) / (STEPS - 1), "launches": loop_launches,
               "decode": "none: no VAE of either package decodes FLUX.2's 32 channels (ROADMAP Queue 3)"}
    del latents

    # (e) build_train_step graphed on seeded 32-channel latents, every block checkpointed
    batch = {**batch, "latents": 2.0 * torch.randn((1, latent, latent, 32), generator=gen, device=dev)}
    expected = {"flash_fwd": 2 * mem.depth + 2, "flash_bwd_dq": mem.depth + 2, "flash_bwd_dkv": mem.depth + 2}
    train = _graph_vs_eager(model, module, batch, kernels, ZL_TRAIN_STEPS, expected,
                            zlab_i1_step_flops(mem, 1, LC_IMG, ZL_TEXT))
    by_shape = train["launches_per_step_by_shape"]
    if by_shape != {"flash_fwd": {joint_key: 2 * mem.depth, connector_key: 2},
                    "flash_bwd_dq": {joint_key: mem.depth, connector_key: 2},
                    "flash_bwd_dkv": {joint_key: mem.depth, connector_key: 2}}:
        raise RuntimeError(f"zlab_i1 train: launches per step by shape {by_shape}")
    normalized = model.transform_latents(batch["latents"])
    train.update({"base": "int8 (built in memory)", "quantized_matmul": "full", "remat": "every U-ViT block",
                  "lora_rank": 16, "flop_checks": flop_checks,
                  "latents": {"raw_std": float(batch["latents"].std()), "normalized_std": float(normalized.std())}})
    del module, model, batch, normalized
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(zl_dir, ignore_errors=True)
    phase("35 zlab_i1", config="zlab-princeton/i1-3B transformer/ as the JAX preset ZlabI1Config() builds it",
          params=sum(math.prod(v) for v in zlab_i1_checkpoint_shapes(full).values()), hidden=full.hidden_size,
          heads=[full.num_heads, full.head_dim], depth={"file": [ZL_FILE_BLOCKS, full.depth],
                                                        "in_memory": [mem.depth, full.depth]},
          tokens={"image": LC_IMG, "text": ZL_TEXT, "joint": ZL_JOINT}, files=files, imported=imported,
          text_encoder=text, parity=parity, sampler=sampler, train=train,
          allocated_gib_before_phase=baseline_gib, seconds=time.perf_counter() - start, device=device)
    return {"zl_joint": {k: v.get(joint_key) for k, v in by_shape.items()},
            "zl_connector": {k: v.get(connector_key) for k, v in by_shape.items()}}


def krea2_flops(arch, batch: int, img_tokens: int, txt_tokens: int) -> tuple:
    """Model FLOPs of one Krea-2 forward, counted from the config, as (the
    part the backward runs through, the part it does not): ``img_in``, per
    block q, k, v, the gate and out (48 query and 12 key/value heads), the
    SwiGLU over every joint token and the joint attention's two products,
    and the head over the image tokens; then the time MLPs and the shared
    modulation per sample, the layerwise fusion blocks over each token's
    taps, the projector, the refiner blocks over the text and ``txt_in``,
    which carry no adapter and take no gradient input."""
    h, c = arch.hidden_size, arch.in_channels
    q, kv = arch.num_attention_heads * arch.attention_head_dim, arch.num_key_value_heads * arch.attention_head_dim
    dt, taps = arch.text_hidden_dim, arch.num_text_layers
    qt = dt
    kvt = arch.text_num_key_value_heads * (dt // arch.text_num_attention_heads)
    joint = img_tokens + txt_tokens

    def block(tokens: int, seqs: int, width: int, qw: int, kvw: int, inner: int) -> int:
        per_seq = tokens // seqs
        return tokens * (2 * width * (3 * qw + 2 * kvw) + 6 * width * inner) + seqs * 4 * per_seq * per_seq * qw

    trained = 2 * img_tokens * c * h + arch.num_layers * block(joint, 1, h, q, kv, arch.intermediate_size)
    trained += 2 * img_tokens * h * c
    frozen = 2 * arch.timestep_embed_dim * h + 2 * h * h + 12 * h * h
    frozen += arch.num_layerwise_text_blocks * block(txt_tokens * taps, txt_tokens, dt, qt, kvt,
                                                     arch.text_intermediate_size)
    frozen += 2 * txt_tokens * dt * taps
    frozen += arch.num_refiner_text_blocks * block(txt_tokens, 1, dt, qt, kvt, arch.text_intermediate_size)
    frozen += 2 * txt_tokens * (dt * h + h * h)
    return batch * trained, batch * frozen


def krea2_step_flops(arch, batch: int, img_tokens: int, txt_tokens: int) -> int:
    """Model FLOPs of one Krea-2 train step: the forward, and twice the
    trained part for the backward (bench.py's forward x 3 where a backward
    runs; the text stage, frozen and fed no gradient, once)."""
    trained, frozen = krea2_flops(arch, batch, img_tokens, txt_tokens)
    return 3 * trained + frozen


def cosmos_flops(arch, batch: int, img_tokens: int, txt_tokens: int) -> tuple:
    """Model FLOPs of one Cosmos core forward, counted from the config, as
    (the adapted part, the rest): the patch embed over [C + 1, p] features,
    per block the self-attention's four projections and two products over
    the image tokens, the cross-attention's query and out over the image and
    key and value over the text with its two products, the FFN, and the
    head; then per sample the time MLP, the three AdaLN-LoRA heads a block
    and the output head's, which carry no adapter and take no gradient
    input."""
    h, lora = arch.hidden_size, arch.adaln_lora_dim
    mlp = int(h * arch.mlp_ratio)
    patch = math.prod(arch.patch_size)
    c_in = arch.in_channels + (1 if arch.concat_padding_mask else 0)
    per_block = img_tokens * (8 * h * h + 4 * h * h + 4 * h * mlp) + 4 * img_tokens * img_tokens * h
    per_block += txt_tokens * 4 * arch.text_embed_dim * h + 4 * img_tokens * txt_tokens * h
    trained = 2 * img_tokens * c_in * patch * h + arch.num_layers * per_block
    trained += 2 * img_tokens * h * patch * arch.out_channels
    heads = 2 * h * lora + 2 * lora * 3 * h if lora != h else 2 * h * 3 * h
    frozen = 2 * h * h + 2 * h * 3 * h + arch.num_layers * 3 * heads + 2 * h * lora + 2 * lora * 2 * h
    return batch * trained, batch * frozen


def cosmos_step_flops(arch, batch: int, img_tokens: int, txt_tokens: int) -> int:
    """Model FLOPs of one Cosmos train step (the adapted part x 3, the rest once)."""
    trained, frozen = cosmos_flops(arch, batch, img_tokens, txt_tokens)
    return 3 * trained + frozen


def anima_flops(arch, batch: int, img_tokens: int, t5_tokens: int, source_tokens: int) -> tuple:
    """Model FLOPs of one Anima forward as (the core's adapted part, the
    rest): the core over the adapter's context padded to
    ``adapter_pad_length``, and the adapter per layer: the self-attention's
    four projections and two products over the T5 tokens, the
    cross-attention's query and out over them and key and value over the
    Qwen tokens with its two products, the 4x MLP; ``out_proj``."""
    d = arch.adapter_dim
    per_layer = t5_tokens * (8 * d * d + 4 * d * d + 16 * d * d) + 4 * t5_tokens * t5_tokens * d
    per_layer += source_tokens * 4 * d * d + 4 * t5_tokens * source_tokens * d
    adapter = arch.adapter_layers * per_layer + 2 * t5_tokens * d * d
    trained, frozen = cosmos_flops(arch.core, 1, img_tokens, max(arch.adapter_pad_length, t5_tokens))
    return batch * trained, batch * (frozen + adapter)


def anima_step_flops(arch, batch: int, img_tokens: int, t5_tokens: int, source_tokens: int) -> int:
    """Model FLOPs of one Anima train step (the core's adapted part x 3, the rest once)."""
    trained, frozen = anima_flops(arch, batch, img_tokens, t5_tokens, source_tokens)
    return 3 * trained + frozen


def omnigen_flops(arch, batch: int, img_tokens: int, txt_tokens: int) -> tuple:
    """Model FLOPs of one OmniGen forward, counted from the config, as (the
    part the backward runs through, the rest): per layer q, k, v and out
    (query and key/value heads), the fused gate_up SwiGLU over every token of
    [prompt | time | image], the image rows' two products against every key
    and the prefix block's two products over the prompt and time token; the
    head over the image tokens; then the patch embed, the two timestep MLPs
    and the final AdaLN, which carry no adapter and take no gradient input."""
    h, heads, kv_heads, inner = arch.hidden_size, arch.num_heads, arch.num_kv_heads, arch.intermediate_size
    hd = h // heads
    prefix = txt_tokens + 1
    seq = prefix + img_tokens
    patch = arch.patch_size ** 2 * arch.in_channels
    block = seq * (2 * h * (heads + 2 * kv_heads) * hd + 2 * heads * hd * h + 6 * h * inner)
    block += 4 * img_tokens * seq * heads * hd + 4 * prefix * prefix * heads * hd
    trained = arch.num_layers * block + 2 * img_tokens * h * patch
    frozen = 2 * img_tokens * patch * h + 2 * (2 * arch.time_step_dim * h + 2 * h * h) + 4 * h * h
    return batch * trained, batch * frozen


def omnigen_step_flops(arch, batch: int, img_tokens: int, txt_tokens: int) -> int:
    """Model FLOPs of one OmniGen train step (the adapted part x 3, the rest once)."""
    trained, frozen = omnigen_flops(arch, batch, img_tokens, txt_tokens)
    return 3 * trained + frozen


def ernie_flops(arch, batch: int, img_tokens: int, txt_tokens: int) -> tuple:
    """Model FLOPs of one ERNIE-Image forward as (the adapted part, the
    rest): ``x_embedder`` over the image tokens, per layer the four
    projections, the gated FFN and the joint attention's two products over
    [image | text], ``final_linear`` over every joint token (the image rows
    are sliced after it); then ``text_proj`` over the text and per sample the
    time MLP, the shared 6-way AdaLN and the final AdaLN, which take no
    gradient input."""
    h, inner = arch.hidden_size, arch.ffn_hidden_size
    seq = img_tokens + txt_tokens
    block = seq * (8 * h * h + 6 * h * inner) + 4 * seq * seq * h
    trained = 2 * img_tokens * arch.in_channels * h + arch.num_layers * block + 2 * seq * h * arch.out_channels
    frozen = (2 * txt_tokens * arch.text_in_dim * h if arch.text_in_dim != h else 0) + 4 * h * h + 12 * h * h + 4 * h * h
    return batch * trained, batch * frozen


def ernie_step_flops(arch, batch: int, img_tokens: int, txt_tokens: int) -> int:
    """Model FLOPs of one ERNIE-Image train step (the adapted part x 3, the rest once)."""
    trained, frozen = ernie_flops(arch, batch, img_tokens, txt_tokens)
    return 3 * trained + frozen


def ideogram_flops(arch, batch: int, img_tokens: int, txt_tokens: int) -> tuple:
    """Model FLOPs of one Ideogram forward (per-sample t) as (the adapted
    part, the rest): ``input_proj`` and ``llm_cond_proj`` over every packed
    token (each zeroed where the other applies), per layer the fused qkv,
    ``o``, the SwiGLU and the joint attention's two products,
    ``final_linear`` over every token; then per sample the time MLP,
    ``adaln_proj``, each layer's 4-way ``adaln_modulation`` and the final
    AdaLN, which take no gradient input."""
    d, inner, a = arch.emb_dim, arch.intermediate_size, arch.adanln_dim
    seq = img_tokens + txt_tokens
    block = seq * (8 * d * d + 6 * d * inner) + 4 * seq * seq * d
    trained = 2 * seq * (arch.in_channels + arch.llm_features_dim) * d + arch.num_layers * block
    trained += 2 * seq * d * arch.in_channels
    frozen = 4 * d * d + 2 * d * a + arch.num_layers * 8 * a * d + 2 * a * d
    return batch * trained, batch * frozen


def ideogram_step_flops(arch, batch: int, img_tokens: int, txt_tokens: int) -> int:
    """Model FLOPs of one Ideogram train step (the adapted part x 3, the rest once)."""
    trained, frozen = ideogram_flops(arch, batch, img_tokens, txt_tokens)
    return 3 * trained + frozen


def _x3(flops):
    """``flops`` (a (trained, frozen) counter) summed and tripled: what
    ``_flop_checks`` divides by 3 to hold against the forward's count."""

    def step_flops(arch, batch, *counts):
        return 3 * sum(flops(arch, batch, *counts))

    step_flops.__name__ = flops.__name__
    return step_flops


def _check_family_trainer(trainer, arch, conditioning: dict) -> dict:
    """The trainer's family arch, the Flux VAE, an int8 base and the batch's
    conditioning shapes, then a replay against an eager step."""
    from simpletuner_tpu_torch.models.vae import VAEConfig

    example = trainer._example_batch()
    shapes = {k: tuple(v.shape) for k, v in example.items() if k.startswith(("text", "t5"))}
    if trainer.model.arch != arch or trainer.vae.config != VAEConfig.flux() or \
            trainer.model.base_precision != "int8" or shapes != conditioning:
        raise RuntimeError(f"{trainer.model.NAME} trainer: arch {trainer.model.arch}, VAE {trainer.vae.config}, base "
                           f"{trainer.model.base_precision}, batch {shapes}")
    return {"vae": "VAEConfig.flux() (16 latent channels)", **_graph_matches_eager(trainer, ("loss", "grad_norm"))}


def _by_shape_per_step(keys: dict) -> dict:
    """The launches per step by shape of a step that checkpoints every
    block: ``keys`` maps a shape to (its forwards, whether a gradient runs
    through it)."""
    return {"flash_fwd": {k: n * (2 if grad else 1) for k, (n, grad) in keys.items()},
            "flash_bwd_dq": {k: n for k, (n, grad) in keys.items() if grad},
            "flash_bwd_dkv": {k: n for k, (n, grad) in keys.items() if grad}}


def _totals(by_shape: dict) -> dict:
    return {kernel: sum(counts.values()) for kernel, counts in by_shape.items()}


def krea2_phase(paths: dict, kernels, device: str, full_in_memory: bool) -> dict:
    """Phase 36: Krea-2 at the JAX preset's full width (``Krea2Config()``):
    a seeded e4m3 checkpoint at ``K2_FILE_BLOCKS`` of its 28 blocks with the
    four 2560-wide fusion blocks beside phase 29's 2560-wide qwen2-layout
    trunk (linked; written here in a run without phase 29), a word-level
    tokenizer and phase 14's Flux VAE: 16 prompts at 512 tokens through the
    trunk (prompts/s, bf16 against f32) and ``Krea2.encode_text`` (12 taps
    spread over the trunk's states); the import held bitwise; a 1024 px
    true-CFG render; one forward (the caption mask as key ids) against the
    plain attention; 6 graphed LoRA steps through
    ``Trainer.run()`` on an int8 base; the edit
    (``krea2_reference_latents``) step on the file through
    ``build_train_step`` on seeded ``control_latents``; in a run that names
    the phase, all 28 blocks built in memory and their graphed step timed.
    Returns the launches per step of each kernel at its shapes."""
    import gc

    import torch

    from simpletuner_tpu_torch.bench_cache import prompts_for
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import krea2_checkpoint_shapes
    from simpletuner_tpu_torch.models.krea2 import Krea2, Krea2Config, Krea2Transformer
    from simpletuner_tpu_torch.models.layers import init_adapters, init_parameters
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.weight_import import krea2_params_from_checkpoint, load_transformer_params

    start = time.perf_counter()
    work, flux_dir = paths["work"], paths["flux_dir"]
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    tiny = Krea2Config.tiny()
    narrow = dataclasses.replace(tiny, num_attention_heads=2, num_key_value_heads=1, attention_head_dim=24,
                                 axes_dims_rope=(8, 8, 8), text_num_key_value_heads=1, num_text_layers=4)
    cases = []
    for arch, img, txt in ((tiny, 12, 5), (narrow, 8, 3)):
        ids = torch.zeros((txt + img, 3), dtype=torch.int32)
        cases.append((arch, (torch.zeros(2, img, arch.in_channels), torch.zeros(
            2, txt, arch.num_text_layers, arch.text_hidden_dim), torch.full((2,), 0.5), ids,
            torch.ones(2, txt, dtype=torch.int32)), (img, txt)))
    flop_checks = _flop_checks(_x3(krea2_flops), Krea2Transformer, cases)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(36)
    full = Krea2Config()
    if (full.hidden_size, full.num_attention_heads, full.num_key_value_heads, full.attention_head_dim,
            full.num_layers, full.text_hidden_dim, full.num_text_layers, full.axes_dims_rope, full.rope_theta) != \
            (6144, 48, 12, 128, 28, 2560, 12, (32, 48, 48), 1000.0):
        raise RuntimeError(f"not the JAX preset of Krea-2: {full}")
    arch = dataclasses.replace(full, num_layers=K2_FILE_BLOCKS)
    shapes = krea2_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 6e9 or written_before + file_bytes / 1e9 + 0.2 + _reserved(36) > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"krea2: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the phase; "
                           f"it and the later phases write {file_bytes / 1e9 + 0.2 + _reserved(36):.1f} GB of the "
                           f"{RUN_WRITE_TARGET_GB} GB a run may write")

    # (b) the seeded files: the transformer (two e4m3 shards), phase 29's
    # 2560-wide qwen2 trunk and phase 14's Flux VAE linked, the tokenizer
    k2_dir = os.path.join(work, "krea2")
    weights, write_s = _write_e4m3_transformer(k2_dir, shapes, gen)
    trunk = zi_trunk_config()
    trunk_source = paths.get("zi_trunk")
    if trunk_source and os.path.isdir(trunk_source):
        _link_tree(trunk_source, os.path.join(k2_dir, "text_encoder"))
        trunk_files = {"written_by_phase": 29, "layers": [ZI_TRUNK_LAYERS, 36]}
    else:
        trunk_files = {"written_by_phase": 36, "layers": [ZI_TRUNK_LAYERS, 36], "write_s": write_llm_trunk(
            os.path.join(k2_dir, "text_encoder"), trunk, gen, QWEN3_HF)}
    keep = os.path.join(work, "qwen3_4b_trunk")  # the trunk's links for phase 40 (nothing is written)
    if not os.path.isdir(keep):
        _link_tree(os.path.join(k2_dir, "text_encoder"), keep)
    paths["zi_trunk"] = keep
    shutil.rmtree(os.path.join(work, "z_image"), ignore_errors=True)  # phase 29's trunk: linked, disk space
    _link_tree(os.path.join(flux_dir, "vae"), os.path.join(k2_dir, "vae"))
    prompts = [f"{TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]}, {p}" for i, p in enumerate(prompts_for(TEXT_PROMPTS))]
    write_gemma_tokenizer(os.path.join(k2_dir, "tokenizer"), " ".join(TRAIN_CAPTIONS + [K2_PROMPT] + prompts).split())
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "blocks": [K2_FILE_BLOCKS, full.num_layers],
             "fusion_blocks": [full.num_layerwise_text_blocks, full.num_refiner_text_blocks], "qwen2_trunk": trunk_files,
             "written_gb_before": written_before, "written_gb_after": _written_gb(), "free_gb_before": free / 1e9}

    # (c) the prompts at 512 tokens through the qwen2.5-vl spec's encoder, then
    # through the family: 12 taps of the trunk's 3 states stacked (S, L, D)
    spec = Krea2.TEXT_ENCODER_CONFIGURATION[0]
    encoder, text = _encoder_and_report(spec, k2_dir, trunk, K2_TEXT, prompts)
    values = {"model_family": "krea2", "model_type": "full"}
    family = Krea2(config_namespace({**values, "mixed_precision": "bf16"}))
    family.attach_text_encoders([encoder])
    taps = family._select_layers(trunk.num_layers + 1)
    latent = RESOLUTION // 8
    batch = _text_batch(family, K2_PROMPT, (1, latent, latent, 16), dev)
    if {k: tuple(v.shape) for k, v in batch.items()} != {"latents": (1, latent, latent, 16),
                                                         "text_embeds": (1, K2_TEXT, 12, 2560),
                                                         "text_attention_mask": (1, K2_TEXT)}:
        raise RuntimeError(f"krea2: the collated batch {({k: tuple(v.shape) for k, v in batch.items()})}")
    text.update({"taps": list(taps), "caption_valid": int(batch["text_attention_mask"].sum())})
    del encoder, family
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the import, bitwise
    model = ModelRegistry.create("krea2", config_namespace(values))
    if model.arch != arch:
        raise RuntimeError(f"krea2: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()
    imported = _import_bitwise(model, module, k2_dir, weights, krea2_params_from_checkpoint, file_bytes)
    params = sum(math.prod(v) for v in krea2_checkpoint_shapes(full).values())
    del weights, module
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the true-CFG render (unmasked: the render payload's mask rides as
    # ``attention_mask``, which the family does not read) and (f) the parity
    # forward on the collated batch (masked)
    joint_key, refiner_key = f"48x{K2_JOINT}x{K2_JOINT}x128", f"20x{K2_TEXT}x{K2_TEXT}x128"
    taps = full.num_text_layers
    layerwise_key = f"20x{taps}x{taps}x128"  # each text token's taps a sequence
    keys = {joint_key: K2_FILE_BLOCKS, refiner_key: full.num_refiner_text_blocks,
            layerwise_key: full.num_layerwise_text_blocks}
    render, runtime = _image_render(work, "krea2", k2_dir, "k2", kernels, K2_PROMPT, K2_GUIDANCE, keys)
    module, model = runtime.module, runtime.model
    if model.arch != arch or model.NAME != "krea2" or not model.is_flow:
        raise RuntimeError(f"krea2: the runtime built {model.NAME} {model.arch}")
    model.text_encoders = []
    gc.collect()
    torch.cuda.empty_cache()
    noise = torch.randn((1, latent, latent, 16), generator=gen, device=dev)
    launches = _forward_launches(model, module, batch, kernels, K2_SIGMA)
    if launches["flash_fwd"] != keys:
        raise RuntimeError(f"krea2 forward: launches by shape {launches}")
    parity = {**_parity_forward(model, module, batch, noise, K2_SIGMA), "tokens": K2_JOINT,
              "text_valid": int(batch["text_attention_mask"].sum()), "launches_by_shape": launches}
    del runtime, module, model
    gc.collect()
    torch.cuda.empty_cache()

    # (g) Trainer.run(): int8 base, every adapter-carrying linear (the family's
    # preset is unread, as in JAX), 6 graphed steps on four of phase 16's JPEGs
    data = _square_jpegs(work, "k2_data", K2_TRAIN_IMAGES)
    cache = os.path.join(work, "k2_cache")
    config = _image_train_config("krea2", k2_dir, data, cache, os.path.join(work, "k2_train"), K2_TRAIN_STEPS)
    text_keys = {refiner_key: (full.num_refiner_text_blocks, False),
                 layerwise_key: (full.num_layerwise_text_blocks, False)}
    step_keys = {joint_key: (K2_FILE_BLOCKS, True), **text_keys}
    expected = _totals(_by_shape_per_step(step_keys))
    train = _train_graphed(config, kernels, K2_TRAIN_STEPS, expected, krea2_step_flops(arch, 1, LC_IMG, K2_TEXT),
                           lambda trainer: _check_family_trainer(trainer, arch, {
                               "text_embeds": (1, K2_TEXT, 12, 2560), "text_attention_mask": (1, K2_TEXT)}))
    by_shape = train["launches_per_step_by_shape"]
    if by_shape != _by_shape_per_step(step_keys):
        raise RuntimeError(f"krea2 trainer: launches per step by shape {by_shape}")
    train.update({"base": "int8", "quantized_matmul": "full", "remat": "every block", "lora_rank": 16,
                  "flop_checks": flop_checks})
    shutil.rmtree(cache, ignore_errors=True)

    # (h) the edit step: 4,096 clean reference tokens after the target's on a
    # second copy of the grid, build_train_step graphed on the file's blocks
    edit_model = Krea2(config_namespace({**_graph_train_values("krea2", K2_TRAIN_STEPS),
                                         "krea2_reference_latents": True}), arch=arch)
    with torch.device(dev):
        edit_module = load_transformer_params(edit_model, init_adapters(edit_model.create_module(), gen), k2_dir)
    edit_batch = {**batch, "latents": torch.randn((1, latent, latent, 16), generator=gen, device=dev),
                  "control_latents": torch.randn((1, latent, latent, 16), generator=gen, device=dev)}
    edit_key = f"48x{K2_EDIT_JOINT}x{K2_EDIT_JOINT}x128"
    edit_keys = {edit_key: (K2_FILE_BLOCKS, True), **text_keys}
    edit = _graph_vs_eager(edit_model, edit_module, edit_batch, kernels, K2_TRAIN_STEPS,
                           _totals(_by_shape_per_step(edit_keys)), krea2_step_flops(arch, 1, 2 * LC_IMG, K2_TEXT))
    if edit["launches_per_step_by_shape"] != _by_shape_per_step(edit_keys):
        raise RuntimeError(f"krea2 edit: launches per step by shape {edit['launches_per_step_by_shape']}")
    edit.update({"base": "int8", "quantized_matmul": "full", "remat": "every block", "lora_rank": 16,
                 "tokens": {"text": K2_TEXT, "image": LC_IMG, "reference": LC_IMG, "joint": K2_EDIT_JOINT}})
    del edit_module, edit_model, edit_batch
    gc.collect()
    torch.cuda.empty_cache()

    # (i) in a run that names the phase: all 28 blocks in memory (12.8 GB of
    # int8), the zero-init tables and norms drawn so every adapter reaches the loss
    full_depth = None
    if full_in_memory:
        deep = Krea2(config_namespace(_graph_train_values("krea2", K2_TRAIN_STEPS)), arch=full)
        with torch.device(dev):
            deep_module = init_parameters(deep.create_module(), gen)
        with torch.no_grad():
            for name, param in deep_module.named_parameters():
                if "lora" not in name and not param.any():
                    param.normal_(0.0, 0.1, generator=gen)
        deep_keys = {joint_key: (full.num_layers, True), **text_keys}
        full_depth = _graph_vs_eager(deep, deep_module, {k: v for k, v in batch.items()}, kernels, K2_TRAIN_STEPS,
                                     _totals(_by_shape_per_step(deep_keys)),
                                     krea2_step_flops(full, 1, LC_IMG, K2_TEXT))
        if full_depth["launches_per_step_by_shape"] != _by_shape_per_step(deep_keys):
            raise RuntimeError(f"krea2 28 blocks: launches per step by shape {full_depth['launches_per_step_by_shape']}")
        full_depth.update({"blocks": [full.num_layers, full.num_layers], "base": "int8 (built in memory)",
                           "quantized_matmul": "full", "remat": "every block", "lora_rank": 16})
        del deep_module, deep
        gc.collect()
        torch.cuda.empty_cache()
    del batch
    phase("36 krea2", config="krea/krea-2 transformer/ as the JAX preset Krea2Config() builds it", params=params,
          params_per_block=sum(math.prod(v) for k, v in krea2_checkpoint_shapes(full).items()
                               if k.startswith("transformer_blocks.0.")),
          hidden=full.hidden_size, heads=[full.num_attention_heads, full.num_key_value_heads, full.attention_head_dim],
          depth={"file": [K2_FILE_BLOCKS, full.num_layers], "train": [K2_FILE_BLOCKS, full.num_layers],
                 "in_memory": [full.num_layers if full_in_memory else 0, full.num_layers]},
          tokens={"image": LC_IMG, "text": K2_TEXT, "joint": K2_JOINT, "edit_joint": K2_EDIT_JOINT}, files=files,
          text_encoder=text, imported=imported, render=render, parity=parity, train=train, edit=edit, full_depth=full_depth, allocated_gib_before_phase=baseline_gib,
          seconds=time.perf_counter() - start, device=device)
    # the text stage takes no gradient: its backward kernels launch 0 times a step
    return {"k2_joint": {k: v.get(joint_key, 0) for k, v in by_shape.items()},
            "k2_edit_joint": {k: v.get(edit_key, 0) for k, v in edit["launches_per_step_by_shape"].items()},
            "k2_refiner": {k: v.get(refiner_key, 0) for k, v in by_shape.items()},
            "k2_layerwise": {k: v.get(layerwise_key, 0) for k, v in by_shape.items()}}


def cosmos_phase(paths: dict, kernels, device: str) -> dict:
    """Phase 37: Cosmos-Predict2 2B at the JAX preset's full width
    (``Cosmos1Config.predict2_2b()``): a seeded e4m3 checkpoint at
    ``CO_FILE_BLOCKS`` of its 28 blocks, a seeded T5-11B encoder (1024 wide,
    128 heads of 128, relu FFN 65,536; e4m3) at ``T5_11B_LAYERS`` of its 24
    blocks in ``text_encoder``, phase 15's T5 tokenizer (``tokenizer_2``, the
    folder the T5 spec reads) and phase 14's Flux VAE linked: 16 prompts at
    512 tokens through ``Cosmos2Image.encode_text`` (the states past the mask
    zeroed); the import held bitwise; a 1024 px true-CFG render down the EDM
    Euler ladder (x0 predictions); one forward against the plain attention;
    6 graphed LoRA steps through ``Trainer.run()`` on an int8 base (the EDM
    sigma drawn through ``erfinv`` inside the captured step, the weighted x0
    loss); then the 14B width at ``CO14B_BLOCKS`` of its 36 blocks in memory:
    one forward against the plain attention and its graphed step.  Returns
    the launches per step of each kernel at its shapes."""
    import gc

    import numpy as np
    import torch

    from simpletuner_tpu_torch.bench_cache import prompts_for
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import cosmos1_checkpoint_shapes
    from simpletuner_tpu_torch.models.cosmos1 import Cosmos1Config, Cosmos1Transformer
    from simpletuner_tpu_torch.models.cosmos2 import Cosmos2Image
    from simpletuner_tpu_torch.models.layers import init_parameters
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.t5 import T5Config, T5EncoderModel
    from simpletuner_tpu_torch.models.text_encoders import load_text_encoders
    from simpletuner_tpu_torch.models.weight_import import cosmos1_params_from_checkpoint, save_safetensors
    from simpletuner_tpu_torch.schedulers import EDMEulerScheduler
    from simpletuner_tpu_torch.training.validation import build_scheduler

    start = time.perf_counter()
    work, flux_dir = paths["work"], paths["flux_dir"]
    for out in ("krea2", "k2_data", "k2_train", "k2_render"):  # phase 36's: disk space
        shutil.rmtree(os.path.join(work, out), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    tiny = Cosmos1Config.tiny()
    narrow = dataclasses.replace(tiny, num_heads=2, head_dim=24, learnable_pos_embed=False, adaln_lora_dim=48,
                                 text_embed_dim=20, rope_scale=(1.0, 4.0, 4.0))
    flop_checks = _flop_checks(_x3(cosmos_flops), Cosmos1Transformer, [
        (tiny, (torch.zeros(2, 1, 8, 12, 4), torch.full((2,), 0.5), torch.zeros(2, 6, 32)), (24, 6)),
        (narrow, (torch.zeros(2, 1, 4, 8, 4), torch.full((2,), 0.5), torch.zeros(2, 5, 20)), (8, 5))])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(37)
    full, b14 = Cosmos1Config.predict2_2b(), Cosmos1Config.predict2_14b()
    if (full.hidden_size, full.num_heads, full.head_dim, full.num_layers, full.text_embed_dim, full.rope_scale,
            full.learnable_pos_embed, b14.num_heads, b14.num_layers) != (2048, 16, 128, 28, 1024, (1.0, 4.0, 4.0),
                                                                         False, 40, 36):
        raise RuntimeError(f"not the JAX presets of Cosmos-Predict2: {full}, {b14}")
    arch = dataclasses.replace(full, num_layers=CO_FILE_BLOCKS)
    shapes = cosmos1_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 6e9 or written_before + file_bytes / 1e9 + 0.3 + _reserved(37) > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"cosmos: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the phase; "
                           f"it and the later phases write {file_bytes / 1e9 + 0.3 + _reserved(37):.1f} GB of the "
                           f"{RUN_WRITE_TARGET_GB} GB a run may write")

    # (b) the seeded files: the transformer (two e4m3 shards), T5-11B at a cut
    # depth (HF's T5 initialisation scale, e4m3), phase 15's T5 tokenizer and
    # phase 14's Flux VAE linked
    co_dir = os.path.join(work, "cosmos")
    weights, write_s = _write_e4m3_transformer(co_dir, shapes, gen)
    t5_full = T5Config(d_model=1024, d_kv=128, d_ff=65536, num_layers=24, num_heads=128, feed_forward_proj="relu")
    t5_cfg = dataclasses.replace(t5_full, num_layers=T5_11B_LAYERS)
    with torch.device(dev):
        t5 = T5EncoderModel(t5_cfg, torch.float32)
    t5.reset_parameters(gen)
    t5_dir = os.path.join(co_dir, "text_encoder")
    os.makedirs(t5_dir)
    t0 = time.perf_counter()
    save_safetensors({k: v.to(torch.float8_e4m3fn) for k, v in t5.state_dict().items()},
                     os.path.join(t5_dir, "model.safetensors"))
    t5_write_s = time.perf_counter() - t0
    with open(os.path.join(t5_dir, "config.json"), "w") as handle:
        json.dump({**dataclasses.asdict(t5_cfg), "architectures": ["T5EncoderModel"]}, handle)
    t5_params = sum(p.numel() for p in t5.parameters())
    del t5
    torch.cuda.empty_cache()
    _link_tree(os.path.join(flux_dir, "tokenizer_2"), os.path.join(co_dir, "tokenizer_2"))
    _link_tree(os.path.join(flux_dir, "vae"), os.path.join(co_dir, "vae"))
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "blocks": [CO_FILE_BLOCKS, full.num_layers],
             "t5_11b": {"layers": [T5_11B_LAYERS, t5_full.num_layers], "params": t5_params, "dtype": "float8_e4m3fn",
                        "write_s": t5_write_s},
             "written_gb_before": written_before, "written_gb_after": _written_gb(), "free_gb_before": free / 1e9}

    # (c) the prompts at 512 tokens through the T5 spec's encoder and the family
    values = {"model_family": "cosmos", "model_type": "full"}
    family = Cosmos2Image(config_namespace({**values, "mixed_precision": "bf16"}))
    (encoder,) = load_text_encoders(family.TEXT_ENCODER_CONFIGURATION, pretrained_path=co_dir, device="cuda")
    encoder.model.to(torch.bfloat16)
    if encoder.model.config != t5_cfg:
        raise RuntimeError(f"cosmos: the T5 spec read {encoder.model.config}, not {t5_cfg}")
    family.attach_text_encoders([encoder])
    prompts = [f"{TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]}, {p}" for i, p in enumerate(prompts_for(TEXT_PROMPTS))]
    family.encode_text(prompts[:2])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payloads = family.encode_text(prompts)
    encode_s = time.perf_counter() - t0
    states = np.stack([p["text_embeds"] for p in payloads])
    masks = np.stack([p["attention_mask"] for p in payloads])
    if states.shape != (TEXT_PROMPTS, CO_TEXT, 1024) or not np.isfinite(states).all() or \
            np.abs(states[masks == 0]).max() != 0 or not (0 < masks.sum(axis=1)).all():
        raise RuntimeError(f"cosmos text: {states.shape}, valid {masks.sum(axis=1).tolist()}, pads zeroed "
                           f"{np.abs(states[masks == 0]).max()}")
    text = {"prompts": TEXT_PROMPTS, "tokens": CO_TEXT, "encode_s": encode_s, "prompts_per_s": TEXT_PROMPTS / encode_s,
            "valid": [int(masks.sum(axis=1).min()), int(masks.sum(axis=1).max())], "pads_zeroed": True}
    latent = RESOLUTION // 8
    batch = _text_batch(family, CO_PROMPT, (1, latent, latent, 16), dev)
    if {k: tuple(v.shape) for k, v in batch.items()} != {"latents": (1, latent, latent, 16),
                                                         "text_embeds": (1, CO_TEXT, 1024)}:
        raise RuntimeError(f"cosmos: the collated batch {({k: tuple(v.shape) for k, v in batch.items()})}")
    del encoder, family, states
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the import, bitwise
    model = ModelRegistry.create("cosmos", config_namespace(values))
    if model.arch != arch:
        raise RuntimeError(f"cosmos: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()
    imported = _import_bitwise(model, module, co_dir, weights, cosmos1_params_from_checkpoint, file_bytes)
    del weights, module
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the true-CFG render down the EDM Euler ladder and (f) the parity forward
    self_key, cross_key = f"16x{LC_IMG}x{LC_IMG}x128", f"16x{LC_IMG}x{CO_TEXT}x128"
    keys = {self_key: CO_FILE_BLOCKS, cross_key: CO_FILE_BLOCKS}
    render, runtime = _image_render(work, "cosmos", co_dir, "co", kernels, CO_PROMPT, CO_GUIDANCE, keys)
    module, model = runtime.module, runtime.model
    scheduler = build_scheduler(model, STEPS)
    if model.arch != arch or model.NAME != "cosmos" or model.prediction_type != "sample" or \
            not isinstance(scheduler, EDMEulerScheduler):
        raise RuntimeError(f"cosmos: the runtime built {model.NAME} {model.arch}, scheduler {type(scheduler)}")
    render["sigmas"] = scheduler.sigmas.tolist()
    model.text_encoders = []
    gc.collect()
    torch.cuda.empty_cache()
    noise = torch.randn((1, latent, latent, 16), generator=gen, device=dev)
    parity = {**_parity_forward(model, module, batch, noise, CO_SIGMA), "tokens": {"image": LC_IMG, "text": CO_TEXT}}
    del runtime, module, model
    gc.collect()
    torch.cuda.empty_cache()

    # (g) Trainer.run(): int8 base, every adapter-carrying linear, 6 graphed EDM steps
    data = _square_jpegs(work, "co_data", CO_TRAIN_IMAGES)
    cache = os.path.join(work, "co_cache")
    config = _image_train_config("cosmos", co_dir, data, cache, os.path.join(work, "co_train"), CO_TRAIN_STEPS)
    step_keys = {self_key: (CO_FILE_BLOCKS, True), cross_key: (CO_FILE_BLOCKS, True)}
    train = _train_graphed(config, kernels, CO_TRAIN_STEPS, _totals(_by_shape_per_step(step_keys)),
                           cosmos_step_flops(arch, 1, LC_IMG, CO_TEXT),
                           lambda trainer: _check_family_trainer(trainer, arch, {"text_embeds": (1, CO_TEXT, 1024)}))
    by_shape = train["launches_per_step_by_shape"]
    if by_shape != _by_shape_per_step(step_keys):
        raise RuntimeError(f"cosmos trainer: launches per step by shape {by_shape}")
    train.update({"base": "int8", "quantized_matmul": "full", "remat": "every block", "lora_rank": 16,
                  "prediction": "sample (EDM x0)", "flop_checks": flop_checks})
    shutil.rmtree(cache, ignore_errors=True)

    # (h) the 14B width in memory at CO14B_BLOCKS of its 36 blocks
    arch14 = dataclasses.replace(b14, num_layers=CO14B_BLOCKS)
    wide = Cosmos2Image(config_namespace({**_graph_train_values("cosmos", 2), "model_flavour": "14b"}), arch=arch14)
    with torch.device(dev):
        wide_module = init_parameters(wide.create_module(), gen)
    self14, cross14 = f"40x{LC_IMG}x{LC_IMG}x128", f"40x{LC_IMG}x{CO_TEXT}x128"
    launches14 = _forward_launches(wide, wide_module, batch, kernels, CO_SIGMA)
    if launches14["flash_fwd"] != {self14: CO14B_BLOCKS, cross14: CO14B_BLOCKS}:
        raise RuntimeError(f"cosmos 14B forward: launches by shape {launches14}")
    wide_parity = {**_parity_forward(wide, wide_module, batch, noise, CO_SIGMA), "launches_by_shape": launches14}
    keys14 = {self14: (CO14B_BLOCKS, True), cross14: (CO14B_BLOCKS, True)}
    wide_train = _graph_vs_eager(wide, wide_module, dict(batch), kernels, 2, _totals(_by_shape_per_step(keys14)),
                                 cosmos_step_flops(arch14, 1, LC_IMG, CO_TEXT))
    if wide_train["launches_per_step_by_shape"] != _by_shape_per_step(keys14):
        raise RuntimeError(f"cosmos 14B step: launches per step by shape {wide_train['launches_per_step_by_shape']}")
    del wide_module, wide, batch
    gc.collect()
    torch.cuda.empty_cache()
    phase("37 cosmos", config="nvidia/Cosmos-Predict2-2B-Text2Image transformer/ as the JAX preset "
          "Cosmos1Config.predict2_2b() builds it", params=sum(math.prod(v) for v in cosmos1_checkpoint_shapes(
              full).values()), hidden=full.hidden_size, heads=[full.num_heads, full.head_dim],
          depth={"file": [CO_FILE_BLOCKS, full.num_layers], "train": [CO_FILE_BLOCKS, full.num_layers]},
          tokens={"image": LC_IMG, "text": CO_TEXT}, files=files, text_encoder=text, imported=imported,
          render=render, parity=parity, train=train,
          b14={"config": "nvidia/Cosmos-Predict2-14B-Text2Image as the JAX preset Cosmos1Config.predict2_14b() "
                         "builds it", "hidden": b14.hidden_size, "heads": [b14.num_heads, b14.head_dim],
               "depth": [CO14B_BLOCKS, b14.num_layers], "params": sum(math.prod(v) for v in cosmos1_checkpoint_shapes(
                   b14).values()), "parity": wide_parity, "train": wide_train},
          allocated_gib_before_phase=baseline_gib, seconds=time.perf_counter() - start, device=device)
    return {"co_self": {k: v.get(self_key) for k, v in by_shape.items()},
            "co_cross": {k: v.get(cross_key) for k, v in by_shape.items()},
            "co14b_self": {k: v.get(self14) for k, v in wide_train["launches_per_step_by_shape"].items()},
            "co14b_cross": {k: v.get(cross14) for k, v in wide_train["launches_per_step_by_shape"].items()}}


def anima_phase(paths: dict, kernels, device: str) -> dict:
    """Phase 38: Anima at the JAX preset's full width (``AnimaConfig()``): a
    seeded e4m3 checkpoint of the whole 6-layer LLM adapter and
    ``AN_FILE_BLOCKS`` of the core's 28 blocks, a seeded Qwen3-0.6B trunk
    (1024 wide, 16 query and 8 key/value heads of 128, read in the qwen2
    layout) at ``QWEN3_06B_LAYERS`` of its 28 layers, one word-level
    tokenizer in ``tokenizer/`` (the folder both the Qwen encoder and the
    T5 ids read, as in the JAX package) and phase 14's Flux VAE: 16 prompts
    at 256 tokens through the trunk (prompts/s, bf16 against f32) and
    ``Anima.encode_text`` (64 T5 ids from that tokenizer); the import held
    bitwise; a 1024 px true-CFG flow render (the adapter's attentions and the
    core's through the kernels); one forward against the plain attention; 6
    graphed LoRA steps through ``Trainer.run()`` on an int8 base.  Last, the run's writes against its limit.  Returns the
    launches per step of each kernel at the core's shapes."""
    import gc

    import torch

    from simpletuner_tpu_torch.bench_cache import prompts_for
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.anima import Anima, AnimaConfig, AnimaTransformer
    from simpletuner_tpu_torch.models.checkpoint_layouts import anima_checkpoint_shapes
    from simpletuner_tpu_torch.models.cosmos1 import Cosmos1Config
    from simpletuner_tpu_torch.models.llm_encoder import LLMEncoderConfig
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.weight_import import anima_params_from_checkpoint

    start = time.perf_counter()
    work, flux_dir = paths["work"], paths["flux_dir"]
    for out in ("cosmos", "co_data", "co_train", "co_render"):  # phase 37's: disk space
        shutil.rmtree(os.path.join(work, out), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    tiny = AnimaConfig.tiny()
    wider = dataclasses.replace(tiny, adapter_dim=48, adapter_heads=2, adapter_layers=2, adapter_pad_length=8,
                                core=dataclasses.replace(tiny.core, text_embed_dim=48, learnable_pos_embed=False))
    flop_checks = _flop_checks(_x3(anima_flops), AnimaTransformer, [
        (tiny, (torch.zeros(2, 1, 8, 12, 4), torch.full((2,), 0.5), torch.zeros(2, 7, 32),
                torch.ones(2, 9, dtype=torch.int32)), (24, 9, 7)),
        (wider, (torch.zeros(2, 1, 4, 8, 4), torch.full((2,), 0.5), torch.zeros(2, 5, 48),
                 torch.ones(2, 6, dtype=torch.int32)), (8, 6, 5))])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(38)
    full = AnimaConfig()
    if (full.adapter_dim, full.adapter_layers, full.adapter_heads, full.adapter_vocab_size, full.adapter_pad_length,
            full.core) != (1024, 6, 16, 32128, 512, Cosmos1Config.anima()):
        raise RuntimeError(f"not the JAX preset of Anima: {full}")
    arch = dataclasses.replace(full, core=dataclasses.replace(full.core, num_layers=AN_FILE_BLOCKS))
    shapes = anima_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 6e9 or written_before + file_bytes / 1e9 + 0.3 > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"anima: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the phase; "
                           f"it writes {file_bytes / 1e9 + 0.3:.1f} GB of the {RUN_WRITE_TARGET_GB} GB a run may write")

    # (b) the seeded files: the transformer (two e4m3 shards), the Qwen3-0.6B
    # trunk, the tokenizer both encoders read, phase 14's Flux VAE linked
    an_dir = os.path.join(work, "anima")
    weights, write_s = _write_e4m3_transformer(an_dir, shapes, gen)
    qwen_full = LLMEncoderConfig(arch="qwen2", vocab_size=151936, hidden_size=1024, intermediate_size=3072,
                                 num_layers=28, num_heads=16, num_kv_heads=8, head_dim=128, rope_theta=1000000.0,
                                 rms_eps=1e-6, qkv_bias=True)
    qwen = dataclasses.replace(qwen_full, num_layers=QWEN3_06B_LAYERS)
    trunk_write_s = write_llm_trunk(os.path.join(an_dir, "text_encoder"), qwen, gen, QWEN3_HF)
    _link_tree(os.path.join(flux_dir, "vae"), os.path.join(an_dir, "vae"))
    prompts = [f"{TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]}, {p}" for i, p in enumerate(prompts_for(TEXT_PROMPTS))]
    write_gemma_tokenizer(os.path.join(an_dir, "tokenizer"), " ".join(TRAIN_CAPTIONS + [AN_PROMPT] + prompts).split())
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "core_blocks": [AN_FILE_BLOCKS, full.core.num_layers],
             "adapter_layers": [full.adapter_layers, full.adapter_layers],
             "qwen3_0_6b": {"layers": [QWEN3_06B_LAYERS, qwen_full.num_layers], "write_s": trunk_write_s},
             "written_gb_before": written_before, "written_gb_after": _written_gb(), "free_gb_before": free / 1e9}

    # (c) the prompts at 256 tokens through the qwen2.5 spec's encoder, then
    # the family's T5 ids from the same tokenizer folder
    spec = Anima.TEXT_ENCODER_CONFIGURATION[0]
    encoder, text = _encoder_and_report(spec, an_dir, qwen, AN_TEXT, prompts)
    values = {"model_family": "anima", "model_type": "full", "pretrained_model_name_or_path": an_dir}
    family = Anima(config_namespace({**values, "mixed_precision": "bf16"}))
    family.attach_text_encoders([encoder])
    payload = family.encode_text([AN_PROMPT])[0]
    tokenizer = family._resolve_t5_tokenizer()
    if tokenizer is None:
        raise RuntimeError(f"anima: no tokenizer read from {an_dir}/tokenizer for the T5 ids")
    expected_ids = tokenizer(AN_PROMPT, truncation=True, max_length=AN_T5)["input_ids"]
    if payload["t5_ids"].shape != (AN_T5,) or \
            payload["t5_ids"][:len(expected_ids)].tolist() != list(expected_ids) or \
            payload["t5_ids"].max() >= full.adapter_vocab_size:
        raise RuntimeError(f"anima: the T5 ids {payload['t5_ids'].tolist()} are not the tokenizer's {expected_ids}")
    text["t5_ids"] = {"tokens": AN_T5, "valid": len(expected_ids), "from": "tokenizer/ (the Qwen encoder's folder)"}
    latent = RESOLUTION // 8
    batch = _text_batch(family, AN_PROMPT, (1, latent, latent, 16), dev)
    if {k: tuple(v.shape) for k, v in batch.items()} != {"latents": (1, latent, latent, 16),
                                                         "text_embeds": (1, AN_TEXT, 1024), "t5_ids": (1, AN_T5)}:
        raise RuntimeError(f"anima: the collated batch {({k: tuple(v.shape) for k, v in batch.items()})}")
    del encoder, family
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the import, bitwise
    model = ModelRegistry.create("anima", config_namespace(values))
    if model.arch != arch:
        raise RuntimeError(f"anima: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()
    imported = _import_bitwise(model, module, an_dir, weights, anima_params_from_checkpoint, file_bytes)
    del weights, module
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the true-CFG render and (f) the parity forward
    self_key, cross_key = f"16x{LC_IMG}x{LC_IMG}x128", f"16x{LC_IMG}x{full.adapter_pad_length}x128"
    heads, dim = full.adapter_heads, full.adapter_dim // full.adapter_heads
    adapter_keys = {f"{heads}x{AN_T5}x{AN_T5}x{dim}": full.adapter_layers,
                    f"{heads}x{AN_T5}x{AN_TEXT}x{dim}": full.adapter_layers}
    keys = {self_key: AN_FILE_BLOCKS, cross_key: AN_FILE_BLOCKS, **adapter_keys}
    render, runtime = _image_render(work, "anima", an_dir, "an", kernels, AN_PROMPT, AN_GUIDANCE, keys)
    module, model = runtime.module, runtime.model
    if model.arch != arch or model.NAME != "anima" or not model.is_flow:
        raise RuntimeError(f"anima: the runtime built {model.NAME} {model.arch}")
    model.text_encoders = []
    gc.collect()
    torch.cuda.empty_cache()
    noise = torch.randn((1, latent, latent, 16), generator=gen, device=dev)
    parity = {**_parity_forward(model, module, batch, noise, AN_SIGMA),
              "tokens": {"image": LC_IMG, "t5": AN_T5, "qwen": AN_TEXT, "context": full.adapter_pad_length}}
    del runtime, module, model
    gc.collect()
    torch.cuda.empty_cache()

    # (g) Trainer.run(): int8 base, every adapter-carrying linear of the core, 6 graphed steps
    data = _square_jpegs(work, "an_data", AN_TRAIN_IMAGES)
    cache = os.path.join(work, "an_cache")
    config = _image_train_config("anima", an_dir, data, cache, os.path.join(work, "an_train"), AN_TRAIN_STEPS)
    step_keys = {self_key: (AN_FILE_BLOCKS, True), cross_key: (AN_FILE_BLOCKS, True),
                 **{key: (n, False) for key, n in adapter_keys.items()}}
    train = _train_graphed(config, kernels, AN_TRAIN_STEPS, _totals(_by_shape_per_step(step_keys)),
                           anima_step_flops(arch, 1, LC_IMG, AN_T5, AN_TEXT),
                           lambda trainer: _check_family_trainer(trainer, arch, {
                               "text_embeds": (1, AN_TEXT, 1024), "t5_ids": (1, AN_T5)}))
    by_shape = train["launches_per_step_by_shape"]
    if by_shape != _by_shape_per_step(step_keys):
        raise RuntimeError(f"anima trainer: launches per step by shape {by_shape}")
    train.update({"base": "int8", "quantized_matmul": "full", "remat": "every core block", "lora_rank": 16,
                  "flop_checks": flop_checks})
    shutil.rmtree(cache, ignore_errors=True)
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(an_dir, ignore_errors=True)
    phase("38 anima", config="circulus/anima transformer/ as the JAX preset AnimaConfig() builds it",
          params=sum(math.prod(v) for v in anima_checkpoint_shapes(full).values()), hidden=full.core.hidden_size,
          heads=[full.core.num_heads, full.core.head_dim],
          depth={"core": [AN_FILE_BLOCKS, full.core.num_layers], "adapter": [full.adapter_layers, full.adapter_layers]},
          tokens={"image": LC_IMG, "qwen": AN_TEXT, "t5": AN_T5, "context": full.adapter_pad_length}, files=files,
          text_encoder=text, imported=imported, render=render, parity=parity, train=train,
          allocated_gib_before_phase=baseline_gib, seconds=time.perf_counter() - start, device=device)
    self_adapter, cross_adapter = adapter_keys
    # the adapter takes no gradient: its backward kernels launch 0 times a step
    return {"co_self": {k: v.get(self_key, 0) for k, v in by_shape.items()},
            "co_cross": {k: v.get(cross_key, 0) for k, v in by_shape.items()},
            "an_self": {k: v.get(self_adapter, 0) for k, v in by_shape.items()},
            "an_cross": {k: v.get(cross_adapter, 0) for k, v in by_shape.items()}}


def write_phi3_tokenizer(root: str, words) -> None:
    """A tokenizer in ``root`` at Phi-3's 32,064 ids that ``AutoTokenizer``
    reads (``<unk>`` 0, ``<s>`` 1 prepended, ``</s>`` 2, ``<|endoftext|>``
    32,000 the pad, padding on the right): a word-level ``tokenizer.json``
    over ``words`` and single characters, the rest of the 32,000 ids filler
    tokens, the 64 ids past them placeholders, and a ``tokenizer_config.json``."""
    import string

    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, processors

    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for word in sorted({w.lower().strip(",.") for w in words} | set(string.ascii_lowercase + string.digits)):
        vocab.setdefault(word, len(vocab))
    for i in range(len(vocab), 32000):
        vocab[f"<|filler_{i}|>"] = i
    vocab["<|endoftext|>"] = 32000
    for i in range(32001, OG_VOCAB):
        vocab[f"<|placeholder_{i}|>"] = i
    tokenizer = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tokenizer.normalizer = normalizers.Lowercase()
    tokenizer.pre_tokenizer = pre_tokenizers.Whitespace()
    tokenizer.post_processor = processors.TemplateProcessing(single="<s> $A", special_tokens=[("<s>", 1)])
    os.makedirs(root, exist_ok=True)
    tokenizer.save(os.path.join(root, "tokenizer.json"))
    with open(os.path.join(root, "tokenizer_config.json"), "w") as handle:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "model_max_length": 4096,
                   "pad_token": "<|endoftext|>", "eos_token": "</s>", "bos_token": "<s>", "unk_token": "<unk>",
                   "padding_side": "right"}, handle)


def _cfg_sampler(model, module, cond_batch: dict, uncond_batch: dict, kernels, guidance: float, latents_shape,
                 gen, per_forward: dict) -> dict:
    """The flow Euler loop over ``STEPS`` steps with true CFG (two forwards a
    step, the negative prompt's conditioning), without a decode: s per CFG
    step, the launches held to ``per_forward`` (by shape) per forward."""
    import torch

    from simpletuner_tpu_torch.schedulers import classifier_free_guidance
    from simpletuner_tpu_torch.schedulers.sampling import sample_loop
    from simpletuner_tpu_torch.training.validation import build_scheduler

    cond_fn = model.denoise_fn(module, model.inference_conditioning(cond_batch))
    uncond_fn = model.denoise_fn(module, model.inference_conditioning(uncond_batch))
    step_s = []

    def denoise(latents, t):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = classifier_free_guidance(cond_fn(latents, t), uncond_fn(latents, t), guidance)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out

    for kernel in kernels:
        kernel.launches = 0
        kernel.shape_launches.clear()
    t0 = time.perf_counter()
    with torch.no_grad():
        latents = sample_loop(build_scheduler(model, STEPS), denoise,
                              torch.randn(latents_shape, generator=gen, device=gen.device))
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = {kernel.name: kernel.launches for kernel in kernels}
    expected = {key: 2 * STEPS * n for key, n in per_forward.items()}
    if launches != {"flash_fwd": sum(expected.values()), "flash_bwd_dq": 0, "flash_bwd_dkv": 0} or \
            _per_shape(kernels)["flash_fwd"] != expected or len(step_s) != STEPS or \
            tuple(latents.shape) != tuple(latents_shape) or not torch.isfinite(latents).all():
        raise RuntimeError(f"{model.NAME} sampler: launches {launches} ({_per_shape(kernels)}), {len(step_s)} steps, "
                           f"latents {tuple(latents.shape)} finite {bool(torch.isfinite(latents).all())}")
    return {"steps": STEPS, "guidance": guidance, "loop_s": loop_s, "step_s": step_s,
            "s_per_cfg_step": sum(step_s[1:]) / (STEPS - 1), "launches": launches,
            "launches_per_cfg_step": {k: v // STEPS for k, v in launches.items()},
            "decode": "none: both trainers build the 16-channel Flux VAE for a 32-channel family (ROADMAP Queue 3)"}


def _drawn_in_memory(model, gen):
    """``model``'s module built on the card with seeded weights, its zero-init
    tensors (AdaLN, final linears) drawn so every adapter reaches the loss."""
    import torch

    from simpletuner_tpu_torch.models.layers import init_parameters

    with torch.device("cuda"):
        module = init_parameters(model.create_module(), gen)
    with torch.no_grad():
        for name, param in module.named_parameters():
            if "lora" not in name and not param.any():
                param.normal_(0.0, 0.05, generator=gen)
    return module


def omnigen_phase(paths: dict, kernels, device: str, full_in_memory: bool) -> dict:
    """Phase 39: OmniGen at the JAX preset's full width (``OmniGenConfig()``):
    a seeded e4m3 checkpoint at ``OG_FILE_BLOCKS`` of its 32 layers, a seeded
    word-level tokenizer at Phi-3's 32,064 ids in ``tokenizer/`` and a 4-channel
    SD VAE (phase 20's linked where it is still on disk): 16 prompts and a
    caption tokenised by ``OmniGen.encode_text`` at 120 tokens (no text
    encoder: the cache holds the ids); the import held bitwise; a 1024 px
    true-CFG render (the image rows through the kernels at head dim 96, the
    121 prefix rows plain); one forward against the plain attention with the
    caption right-padded and left-padded; 6 graphed LoRA steps through
    ``Trainer.run()`` on an int8 base and four of phase 16's JPEGs; in a run
    that names the phase, all 32 layers built in memory and their graphed step
    timed.  Returns the launches per step of each kernel at the image-row shape."""
    import gc

    import numpy as np
    import torch

    from simpletuner_tpu_torch.bench_cache import prompts_for
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import omnigen_checkpoint_shapes, vae_checkpoint_shapes
    from simpletuner_tpu_torch.models.omnigen import OmniGen, OmniGenConfig, OmniGenTransformer
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from simpletuner_tpu_torch.models.weight_import import omnigen_params_from_diffusers, save_safetensors

    start = time.perf_counter()
    work = paths["work"]
    for out in ("anima", "an_data", "an_train", "an_render", "an_cache"):  # phase 38's: disk space
        shutil.rmtree(os.path.join(work, out), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    tiny = OmniGenConfig.tiny()
    narrow = dataclasses.replace(tiny, hidden_size=48, num_heads=3, num_kv_heads=3, intermediate_size=40, num_layers=1)
    flop_checks = _flop_checks(_x3(omnigen_flops), OmniGenTransformer, [
        (arch, (torch.zeros(2, h, w, 4), torch.full((2,), 0.5), torch.zeros(2, txt, dtype=torch.int32),
                torch.ones(2, txt)), ((h // 2) * (w // 2), txt))
        for arch, (h, w), txt in ((tiny, (8, 12), 6), (narrow, (4, 8), 5))])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(39)
    full = OmniGenConfig()
    if (full.hidden_size, full.num_heads, full.num_kv_heads, full.intermediate_size, full.num_layers,
            full.vocab_size, full.in_channels, full.pos_embed_max_size) != (3072, 32, 32, 8192, 32, OG_VOCAB, 4, 192):
        raise RuntimeError(f"not the JAX preset of OmniGen: {full}")
    arch = dataclasses.replace(full, num_layers=OG_FILE_BLOCKS)
    shapes = omnigen_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 6e9 or written_before + file_bytes / 1e9 + 0.2 + _reserved(39) > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"omnigen: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the phase; "
                           f"it and the later phases write {file_bytes / 1e9 + 0.2 + _reserved(39):.1f} GB of the "
                           f"{RUN_WRITE_TARGET_GB} GB a run may write")

    # (b) the seeded files: the transformer (two e4m3 shards), the Phi-3-sized
    # tokenizer and the 4-channel VAE
    og_dir = os.path.join(work, "omnigen")
    weights, write_s = _write_e4m3_transformer(og_dir, shapes, gen)
    prompts = [f"{TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]}, {p}" for i, p in enumerate(prompts_for(TEXT_PROMPTS))]
    write_phi3_tokenizer(os.path.join(og_dir, "tokenizer"), " ".join(TRAIN_CAPTIONS + [OG_PROMPT] + prompts).split())
    sdxl_vae = os.path.join(work, "sdxl", "vae")
    if os.path.isdir(sdxl_vae):
        _link_tree(sdxl_vae, os.path.join(og_dir, "vae"))
    else:
        with torch.device(dev):
            vae = AutoencoderKL(VAEConfig(), torch.bfloat16)
        os.makedirs(os.path.join(og_dir, "vae"))
        save_safetensors(seeded_weights(vae_checkpoint_shapes(vae), gen),
                         os.path.join(og_dir, "vae", "diffusion_pytorch_model.safetensors"))
        del vae
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "blocks": [OG_FILE_BLOCKS, full.num_layers],
             "vae": "phase 20's, linked" if os.path.isdir(sdxl_vae) else "seeded here (4 channels, bf16)",
             "written_gb_before": written_before, "written_gb_after": _written_gb(), "free_gb_before": free / 1e9}

    # (c) no text encoder: the family tokenises (int32 ids and a float mask at 120 tokens)
    values = {"model_family": "omnigen", "model_type": "full", "pretrained_model_name_or_path": og_dir,
              "mixed_precision": "bf16"}
    family = OmniGen(config_namespace(values))
    if family.TEXT_ENCODER_CONFIGURATION != ():
        raise RuntimeError("omnigen: the family names a text encoder")
    family.encode_text(prompts[:2])  # the tokenizer's load
    t0 = time.perf_counter()
    payloads = family.encode_text(prompts)
    encode_s = time.perf_counter() - t0
    ids = np.stack([p["input_ids"] for p in payloads])
    valid = np.stack([p["text_attention_mask"] for p in payloads]).sum(axis=1)
    if ids.shape != (TEXT_PROMPTS, OG_TEXT) or ids.dtype != np.int32 or ids.max() >= OG_VOCAB or \
            payloads[0]["text_attention_mask"].dtype != np.float32 or not (1 < valid).all() or \
            not (valid < OG_TEXT).all():
        raise RuntimeError(f"omnigen text: ids {ids.shape} {ids.dtype} max {ids.max()}, valid {valid.tolist()}")
    text = {"tokenizer": "word-level at Phi-3's 32,064 ids (tokenizer/, AutoTokenizer), padding right",
            "prompts": TEXT_PROMPTS, "tokens": OG_TEXT, "encode_s": encode_s,
            "prompts_per_s": TEXT_PROMPTS / encode_s, "valid_tokens": [int(valid.min()), int(valid.max())]}
    latent = RESOLUTION // 8
    batch = _text_batch(family, OG_PROMPT, (1, latent, latent, 4), dev)
    if {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} != {
            "latents": ((1, latent, latent, 4), torch.float32), "input_ids": ((1, OG_TEXT), torch.int32),
            "text_attention_mask": ((1, OG_TEXT), torch.float32)}:
        raise RuntimeError(f"omnigen: the collated batch {({k: tuple(v.shape) for k, v in batch.items()})}")
    text["caption_valid"] = int(batch["text_attention_mask"].sum())
    del family

    # (d) the import, bitwise
    model = ModelRegistry.create("omnigen", config_namespace(values))
    if model.arch != arch:
        raise RuntimeError(f"omnigen: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()
    imported = _import_bitwise(model, module, og_dir, weights, omnigen_params_from_diffusers, file_bytes)
    params = sum(math.prod(v) for v in omnigen_checkpoint_shapes(full).values())
    del weights, module
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the true-CFG render (masked: the payload keys are the collate's) and
    # (f) the parity forward, right- and left-padded
    og_key = f"32x{LC_IMG}x{OG_JOINT}x96"
    keys = {og_key: OG_FILE_BLOCKS}
    render, runtime = _image_render(work, "omnigen", og_dir, "og", kernels, OG_PROMPT, OG_GUIDANCE, keys)
    module, model = runtime.module, runtime.model
    if model.arch != arch or model.NAME != "omnigen" or runtime.trainer.vae.config != VAEConfig():
        raise RuntimeError(f"omnigen: the runtime built {model.NAME} {model.arch}, VAE {runtime.trainer.vae.config}")
    noise = torch.randn((1, latent, latent, 4), generator=gen, device=dev)
    launches = _forward_launches(model, module, batch, kernels, OG_SIGMA)
    if launches["flash_fwd"] != keys:
        raise RuntimeError(f"omnigen forward: launches by shape {launches}")
    parity = {**_parity_forward(model, module, batch, noise, OG_SIGMA), "tokens": OG_JOINT,
              "text_valid": text["caption_valid"], "launches_by_shape": launches}
    left = {**batch, "input_ids": batch["input_ids"].flip(1), "text_attention_mask": batch["text_attention_mask"].flip(1)}
    parity["left_padded"] = _parity_forward(model, module, left, noise, OG_SIGMA)
    del runtime, module, model
    gc.collect()
    torch.cuda.empty_cache()

    # (g) Trainer.run(): int8 base, every adapter-carrying linear (the blocks'
    # six projections), 6 graphed steps on four of phase 16's JPEGs
    data = _square_jpegs(work, "og_data", OG_TRAIN_IMAGES)
    cache = os.path.join(work, "og_cache")
    config = _image_train_config("omnigen", og_dir, data, cache, os.path.join(work, "og_train"), OG_TRAIN_STEPS)
    step_keys = {og_key: (OG_FILE_BLOCKS, True)}

    def check(trainer):
        example = trainer._example_batch()
        conditioning = {k: (tuple(v.shape), str(v.dtype)) for k, v in example.items() if k.startswith(("input", "text"))}
        if trainer.model.arch != arch or trainer.vae.config != VAEConfig() or trainer.model.base_precision != "int8" \
                or conditioning != {"input_ids": ((1, OG_TEXT), "int32"), "text_attention_mask": ((1, OG_TEXT),
                                                                                                 "float32")}:
            raise RuntimeError(f"omnigen trainer: arch {trainer.model.arch}, VAE {trainer.vae.config}, base "
                               f"{trainer.model.base_precision}, batch {conditioning}")
        return {"vae": "VAEConfig() (the SD VAE, scaling 0.18215 in the cache; validation divides by 0.13025)",
                "text_encoders": len(trainer.model.TEXT_ENCODER_CONFIGURATION),
                **_graph_matches_eager(trainer, ("loss", "grad_norm"))}

    train = _train_graphed(config, kernels, OG_TRAIN_STEPS, _totals(_by_shape_per_step(step_keys)),
                           omnigen_step_flops(arch, 1, LC_IMG, OG_TEXT), check)
    by_shape = train["launches_per_step_by_shape"]
    if by_shape != _by_shape_per_step(step_keys):
        raise RuntimeError(f"omnigen trainer: launches per step by shape {by_shape}")
    train.update({"base": "int8", "quantized_matmul": "full", "remat": "every layer", "lora_rank": 16,
                  "flop_checks": flop_checks})
    shutil.rmtree(cache, ignore_errors=True)

    # (h) in a run that names the phase: all 32 layers built in memory, graphed
    full_depth = None
    if full_in_memory:
        deep = OmniGen(config_namespace(_graph_train_values("omnigen", OG_TRAIN_STEPS)), arch=full)
        deep_keys = {og_key: (full.num_layers, True)}
        deep_batch = {**batch, "latents": torch.randn((1, latent, latent, 4), generator=gen, device=dev)}
        full_depth = _graph_vs_eager(deep, _drawn_in_memory(deep, gen), deep_batch, kernels, OG_TRAIN_STEPS,
                                     _totals(_by_shape_per_step(deep_keys)),
                                     omnigen_step_flops(full, 1, LC_IMG, OG_TEXT))
        if full_depth["launches_per_step_by_shape"] != _by_shape_per_step(deep_keys):
            raise RuntimeError(f"omnigen 32 layers: launches per step by shape "
                               f"{full_depth['launches_per_step_by_shape']}")
        full_depth.update({"blocks": [full.num_layers, full.num_layers], "base": "int8 (built in memory)",
                           "quantized_matmul": "full", "remat": "every layer", "lora_rank": 16})
        del deep, deep_batch
        gc.collect()
        torch.cuda.empty_cache()
    del batch
    phase("39 omnigen", config="Shitao/OmniGen-v1-diffusers transformer/ as the JAX preset OmniGenConfig() builds it",
          params=params, params_per_layer=sum(math.prod(v) for k, v in shapes.items() if k.startswith("layers.0.")),
          hidden=full.hidden_size, heads=[full.num_heads, full.num_kv_heads, full.hidden_size // full.num_heads],
          depth={"file": [OG_FILE_BLOCKS, full.num_layers], "train": [OG_FILE_BLOCKS, full.num_layers],
                 "in_memory": [full.num_layers if full_in_memory else 0, full.num_layers]},
          tokens={"prompt": OG_TEXT, "prefix": OG_PREFIX, "image": LC_IMG, "joint": OG_JOINT},
          attention={"image_rows": "flash kernels, query ids 1, key ids 1 / -1 (the prompt pads)",
                     "prefix_rows": "plain causal block (phase 3 times it)"},
          files=files, text=text, imported=imported, render=render, parity=parity, train=train,
          full_depth=full_depth, allocated_gib_before_phase=baseline_gib, seconds=time.perf_counter() - start,
          device=device)
    return {"og_image_rows": {k: v.get(og_key, 0) for k, v in by_shape.items()}}


def ernie_phase(paths: dict, kernels, device: str, full_in_memory: bool) -> dict:
    """Phase 40: ERNIE-Image at the JAX preset's full width (``ErnieConfig()``):
    a seeded e4m3 checkpoint at ``ER_FILE_BLOCKS`` of its 24 layers with
    ``text_proj``, phase 29's 2560-wide qwen2-layout trunk linked (written here
    in a run without it) and a word-level tokenizer: 16 prompts at 512 tokens
    through the ``qwen2.5`` spec (prompts/s, bf16 against f32); the import held
    bitwise; one forward against the plain attention (the text lengths as key
    ids); the flow Euler loop with true CFG over 32-channel latents, without a
    decode; 6 graphed LoRA steps on an int8 base through ``build_train_step``
    (the 32-channel wall stops ``Trainer.run()`` in both packages); in a run
    that names the phase, all 24 layers built in memory and their graphed step
    timed.  Returns the launches per step of each kernel at the joint shape."""
    import gc

    import torch

    from simpletuner_tpu_torch.bench_cache import prompts_for
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import ernie_checkpoint_shapes
    from simpletuner_tpu_torch.models.ernie import Ernie, ErnieConfig, ErnieTransformer
    from simpletuner_tpu_torch.models.layers import init_adapters
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.vae import VAEConfig
    from simpletuner_tpu_torch.models.weight_import import ernie_params_from_checkpoint, load_transformer_params

    start = time.perf_counter()
    work = paths["work"]
    for out in ("omnigen", "og_data", "og_train", "og_render", "og_cache"):  # phase 39's: disk space
        shutil.rmtree(os.path.join(work, out), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    tiny = ErnieConfig.tiny()
    narrow = dataclasses.replace(tiny, hidden_size=48, num_heads=3, text_in_dim=48, ffn_hidden_size=40, num_layers=1)
    flop_checks = _flop_checks(_x3(ernie_flops), ErnieTransformer, [
        (arch, (torch.zeros(2, h, w, arch.in_channels), torch.full((2,), 500.0),
                torch.zeros(2, txt, arch.text_in_dim), torch.full((2,), txt)), (h * w, txt))
        for arch, (h, w), txt in ((tiny, (4, 6), 5), (narrow, (2, 4), 3))])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(40)
    full = ErnieConfig()
    if (full.hidden_size, full.num_heads, full.head_dim, full.num_layers, full.ffn_hidden_size, full.in_channels,
            full.text_in_dim, full.rope_theta, full.rope_axes_dim) != (3072, 24, 128, 24, 8192, 128, 2560, 256.0,
                                                                      (32, 48, 48)):
        raise RuntimeError(f"not the JAX preset of ERNIE-Image: {full}")
    arch = dataclasses.replace(full, num_layers=ER_FILE_BLOCKS)
    shapes = ernie_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 6e9 or written_before + file_bytes / 1e9 + 0.05 + _reserved(40) > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"ernie: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the phase; "
                           f"it and the later phases write {file_bytes / 1e9 + 0.05 + _reserved(40):.1f} GB of the "
                           f"{RUN_WRITE_TARGET_GB} GB a run may write")

    # (b) the seeded transformer (two e4m3 shards; the zero-init AdaLN and
    # final linear drawn), the 2560-wide trunk linked and a word-level tokenizer
    er_dir = os.path.join(work, "ernie")
    weights, write_s = _write_e4m3_transformer(er_dir, shapes, gen)
    trunk = zi_trunk_config()
    trunk_source = paths.get("zi_trunk")
    if trunk_source and os.path.isdir(trunk_source):
        _link_tree(trunk_source, os.path.join(er_dir, "text_encoder"))
        trunk_files = {"linked": True, "layers": [ZI_TRUNK_LAYERS, 36]}
    else:
        trunk_files = {"written_by_phase": 40, "layers": [ZI_TRUNK_LAYERS, 36], "write_s": write_llm_trunk(
            os.path.join(er_dir, "text_encoder"), trunk, gen, QWEN3_HF)}
    prompts = [f"{TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]}, {p}" for i, p in enumerate(prompts_for(TEXT_PROMPTS))]
    write_gemma_tokenizer(os.path.join(er_dir, "tokenizer"), " ".join(TRAIN_CAPTIONS + [ER_PROMPT] + prompts).split())
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "blocks": [ER_FILE_BLOCKS, full.num_layers],
             "qwen2_trunk": trunk_files, "written_gb_before": written_before, "written_gb_after": _written_gb(),
             "free_gb_before": free / 1e9}

    # (c) the prompts at 512 tokens through the qwen2.5 spec: the final-norm states
    spec = Ernie.TEXT_ENCODER_CONFIGURATION[0]
    encoder, text = _encoder_and_report(spec, er_dir, trunk, ER_TEXT, prompts)
    values = {"model_family": "ernie", "model_type": "full", "mixed_precision": "bf16"}
    family = Ernie(config_namespace(values))
    family.attach_text_encoders([encoder])
    latent = RESOLUTION // 8
    batch = _text_batch(family, ER_PROMPT, (1, latent, latent, 32), dev)
    negative = _text_batch(family, "", (1, latent, latent, 32), dev)
    if {k: tuple(v.shape) for k, v in batch.items()} != {"latents": (1, latent, latent, 32),
                                                         "text_embeds": (1, ER_TEXT, 2560),
                                                         "text_attention_mask": (1, ER_TEXT)}:
        raise RuntimeError(f"ernie: the collated batch {({k: tuple(v.shape) for k, v in batch.items()})}")
    text["caption_valid"] = int(batch["text_attention_mask"].sum())
    del encoder, family
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the import, bitwise
    model = ModelRegistry.create("ernie", config_namespace(values))
    if model.arch != arch:
        raise RuntimeError(f"ernie: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()
    imported = _import_bitwise(model, module, er_dir, weights, ernie_params_from_checkpoint, file_bytes)
    params = sum(math.prod(v) for v in ernie_checkpoint_shapes(full).values())
    del weights

    # (e) the parity forward (the caption's length as key ids) and (f) the CFG sampler loop, no decode
    er_key = f"24x{ER_JOINT}x{ER_JOINT}x128"
    keys = {er_key: ER_FILE_BLOCKS}
    noise = torch.randn((1, latent, latent, 32), generator=gen, device=dev)
    launches = _forward_launches(model, module, batch, kernels, ER_SIGMA)
    if launches["flash_fwd"] != keys:
        raise RuntimeError(f"ernie forward: launches by shape {launches}")
    parity = {**_parity_forward(model, module, batch, noise, ER_SIGMA), "tokens": ER_JOINT,
              "text_valid": text["caption_valid"], "launches_by_shape": launches}
    sampler = _cfg_sampler(model, module, batch, negative, kernels, ER_GUIDANCE, (1, latent, latent, 32), gen, keys)
    del module, model, negative
    gc.collect()
    torch.cuda.empty_cache()

    # (g) 6 graphed rank-16 LoRA steps on an int8 base, every layer checkpointed,
    # through build_train_step (both trainers stop at the 32-channel wall)
    wall = {"latent_channels": Ernie.LATENT_CHANNEL_COUNT, "trainer_vae_channels": VAEConfig.flux().latent_channels,
            "x_embedder_features": full.in_channels}
    if (wall["latent_channels"], wall["trainer_vae_channels"]) != (32, 16):
        raise RuntimeError(f"ernie: the 32-channel wall moved: {wall}")
    train_model = Ernie(config_namespace(_graph_train_values("ernie", ER_TRAIN_STEPS)))
    with torch.device(dev):
        train_module = load_transformer_params(train_model, init_adapters(train_model.create_module(), gen), er_dir)
    train_batch = {**batch, "latents": torch.randn((1, latent, latent, 32), generator=gen, device=dev)}
    step_keys = {er_key: (ER_FILE_BLOCKS, True)}
    train = _graph_vs_eager(train_model, train_module, train_batch, kernels, ER_TRAIN_STEPS,
                            _totals(_by_shape_per_step(step_keys)), ernie_step_flops(arch, 1, LC_IMG, ER_TEXT))
    by_shape = train["launches_per_step_by_shape"]
    if by_shape != _by_shape_per_step(step_keys):
        raise RuntimeError(f"ernie train: launches per step by shape {by_shape}")
    train.update({"base": "int8", "quantized_matmul": "full", "remat": "every layer", "lora_rank": 16,
                  "lora_targets": "every adapter-carrying linear (the JAX family's default)", "wall": wall,
                  "flop_checks": flop_checks})
    del train_module, train_model
    gc.collect()
    torch.cuda.empty_cache()

    # (h) in a run that names the phase: all 24 layers built in memory, graphed
    full_depth = None
    if full_in_memory:
        deep = Ernie(config_namespace(_graph_train_values("ernie", ER_TRAIN_STEPS)), arch=full)
        deep_keys = {er_key: (full.num_layers, True)}
        full_depth = _graph_vs_eager(deep, _drawn_in_memory(deep, gen), train_batch, kernels, ER_TRAIN_STEPS,
                                     _totals(_by_shape_per_step(deep_keys)), ernie_step_flops(full, 1, LC_IMG, ER_TEXT))
        if full_depth["launches_per_step_by_shape"] != _by_shape_per_step(deep_keys):
            raise RuntimeError(f"ernie 24 layers: launches per step by shape {full_depth['launches_per_step_by_shape']}")
        full_depth.update({"blocks": [full.num_layers, full.num_layers], "base": "int8 (built in memory)",
                           "quantized_matmul": "full", "remat": "every layer", "lora_rank": 16})
        del deep
        gc.collect()
        torch.cuda.empty_cache()
    del batch, train_batch
    phase("40 ernie", config="baidu/ERNIE-4.5-VL-image transformer/ as the JAX preset ErnieConfig() builds it",
          params=params, params_per_layer=sum(math.prod(v) for k, v in shapes.items() if k.startswith("layers.0.")),
          hidden=full.hidden_size, heads=[full.num_heads, full.head_dim],
          depth={"file": [ER_FILE_BLOCKS, full.num_layers], "train": [ER_FILE_BLOCKS, full.num_layers],
                 "in_memory": [full.num_layers if full_in_memory else 0, full.num_layers]},
          tokens={"image": LC_IMG, "text": ER_TEXT, "joint": ER_JOINT}, latent_channels=32, files=files,
          text_encoder=text, imported=imported, parity=parity, sampler=sampler, train=train, full_depth=full_depth,
          allocated_gib_before_phase=baseline_gib, seconds=time.perf_counter() - start, device=device)
    return {"er_joint": {k: v.get(er_key, 0) for k, v in by_shape.items()}}


def ideogram_phase(paths: dict, kernels, device: str, full_in_memory: bool) -> dict:
    """Phase 41: Ideogram at the JAX preset's full width (``IdeogramConfig()``):
    a seeded e4m3 checkpoint at ``ID_FILE_BLOCKS`` of its 34 layers with the
    whole 53,248 -> 4608 ``llm_cond_proj`` and a word-level tokenizer; a seeded
    4096-wide qwen2-layout trunk (Qwen3-VL-8B's text sizes) at
    ``ID_TRUNK_LAYERS`` of 36 built in memory, 16 prompts at 512 tokens through
    it (prompts/s, bf16 against f32) and a caption through
    ``Ideogram.encode_text`` (the auto-json path; 13 taps spread over the
    trunk's 3 states, 53,248 features); the enhancer's greedy loop for
    ``ID_UPSAMPLE_TOKENS`` tokens on a seeded 151,936 x 4096 head held on the
    card; the import held bitwise; one forward against the plain attention at
    head dim 256 (the text mask as segment ids, the pads at 0); the flow Euler
    loop with true CFG over 32-channel latents, without a decode; 6 graphed
    LoRA steps on an int8 base through ``build_train_step``; in a run that
    names the phase, all 34 layers built in memory (9.2 GB of int8) and their
    graphed step timed.  Last, the run's writes against the target.  Returns
    the launches per step of each kernel at the joint shape."""
    import gc

    import numpy as np
    import torch

    from simpletuner_tpu_torch.bench_cache import prompts_for
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import ideogram_checkpoint_shapes
    from simpletuner_tpu_torch.models.ideogram import Ideogram, IdeogramConfig, IdeogramTransformer
    from simpletuner_tpu_torch.models.ideogram.prompt_enhancer import upsample_prompt
    from simpletuner_tpu_torch.models.layers import init_adapters
    from simpletuner_tpu_torch.models.llm_encoder import LLMEncoder, LLMEncoderConfig
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.text_encoders import LLMTextEncoder, _tokenizer
    from simpletuner_tpu_torch.models.weight_import import ideogram_params_from_checkpoint, load_transformer_params

    start = time.perf_counter()
    work = paths["work"]
    for out in ("ernie", "qwen3_4b_trunk"):  # phase 40's and the 2560-wide trunk's links: disk space
        shutil.rmtree(os.path.join(work, out), ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    tiny = IdeogramConfig.tiny()
    narrow = dataclasses.replace(tiny, emb_dim=48, num_heads=2, intermediate_size=40, num_layers=1, llm_taps=2,
                                 mrope_section=(6, 3, 3))
    cases = []
    for arch, (h, w), txt in ((tiny, (8, 12), 6), (narrow, (4, 8), 5)):
        packing = Ideogram(config_namespace({"model_family": "ideogram", "model_arch_preset": "tiny"}), arch=arch)
        inputs = packing.get_model_inputs({
            "noisy_latents": torch.zeros(2, h, w, arch.in_channels // 4), "timesteps": torch.full((2,), 0.5),
            "text_embeds": torch.zeros(2, txt, arch.llm_features_dim),
            "text_attention_mask": torch.ones(2, txt, dtype=torch.int32)})
        cases.append((arch, tuple(inputs[k] for k in ("llm_features", "x", "t", "position_ids", "segment_ids",
                                                      "indicator")), ((h // 2) * (w // 2), txt)))
    flop_checks = _flop_checks(_x3(ideogram_flops), IdeogramTransformer, cases)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(41)
    full = IdeogramConfig()
    if (full.emb_dim, full.num_heads, full.head_dim, full.num_layers, full.intermediate_size, full.in_channels,
            full.llm_features_dim, full.rope_theta, full.mrope_section) != (4608, 18, 256, 34, 12288, 128, 53248,
                                                                           5e6, (24, 20, 20)):
        raise RuntimeError(f"not the JAX preset of Ideogram: {full}")
    arch = dataclasses.replace(full, num_layers=ID_FILE_BLOCKS)
    shapes = ideogram_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 6e9 or written_before + file_bytes / 1e9 + 0.05 > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"ideogram: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the "
                           f"phase; it writes {file_bytes / 1e9 + 0.05:.1f} GB of the {RUN_WRITE_TARGET_GB} GB a "
                           "run may write")

    # (b) the seeded transformer (two e4m3 shards) and a word-level tokenizer
    id_dir = os.path.join(work, "ideogram")
    weights, write_s = _write_e4m3_transformer(id_dir, shapes, gen)
    prompts = [f"{TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]}, {p}" for i, p in enumerate(prompts_for(TEXT_PROMPTS))]
    write_gemma_tokenizer(os.path.join(id_dir, "tokenizer"), " ".join(TRAIN_CAPTIONS + [ID_PROMPT] + prompts).split())
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "blocks": [ID_FILE_BLOCKS, full.num_layers],
             "llm_cond_proj": [full.emb_dim, full.llm_features_dim], "written_gb_before": written_before,
             "written_gb_after": _written_gb(), "free_gb_before": free / 1e9}

    # (c) the 4096-wide qwen2-layout trunk at ID_TRUNK_LAYERS, seeded in
    # memory; 512-token prompts, then the family's 13 taps of the auto-json captions
    trunk_cfg = LLMEncoderConfig(arch="qwen2", vocab_size=151936, hidden_size=4096, intermediate_size=12288,
                                 num_layers=ID_TRUNK_LAYERS, num_heads=32, num_kv_heads=8, head_dim=128,
                                 rope_theta=5000000.0, rms_eps=1e-6, qkv_bias=True)
    spec = Ideogram.TEXT_ENCODER_CONFIGURATION[0]
    t0 = time.perf_counter()
    with torch.device(dev):
        trunk = LLMEncoder(trunk_cfg)
    trunk.reset_parameters(torch.Generator(device=dev).manual_seed(410))
    encoder = LLMTextEncoder(spec, trunk.eval(), _tokenizer("AutoTokenizer", id_dir, "tokenizer"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    text = _llm_text_report(spec, None, trunk_cfg, ID_TEXT, prompts, encoder=encoder)
    values = {"model_family": "ideogram", "model_type": "full", "mixed_precision": "bf16"}
    family = Ideogram(config_namespace(values))
    family.attach_text_encoders([encoder])
    taps = family._select_taps(trunk_cfg.num_layers + 1)
    latent = RESOLUTION // 8
    batch = _text_batch(family, ID_PROMPT, (1, latent, latent, 32), dev)
    negative = _text_batch(family, "", (1, latent, latent, 32), dev)
    if {k: tuple(v.shape) for k, v in batch.items()} != {"latents": (1, latent, latent, 32),
                                                         "text_embeds": (1, ID_TEXT, 53248),
                                                         "text_attention_mask": (1, ID_TEXT)}:
        raise RuntimeError(f"ideogram: the collated batch {({k: tuple(v.shape) for k, v in batch.items()})}")
    caption = family._preprocess_prompts([ID_PROMPT])[0]
    text.update({"layers": [ID_TRUNK_LAYERS, 36], "built_in_memory_s": build_s, "taps": list(taps),
                 "features": int(batch["text_embeds"].shape[-1]), "caption_valid": int(batch["text_attention_mask"].sum()),
                 "auto_json_caption_chars": len(caption), "auto_json_keys": list(json.loads(caption))})

    # (d) the enhancer's greedy loop on a seeded head held on the card
    # (151,936 x 4096 f32; the tokenizer's ids drawn larger so it speaks them)
    head = torch.randn((trunk_cfg.hidden_size, trunk_cfg.vocab_size), generator=gen, device=dev) * 0.01
    words = len(encoder.tokenizer)
    head[:, :words] *= 100.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    upsampled = upsample_prompt(encoder, head, ID_PROMPT, temperature=0.0, max_new_tokens=ID_UPSAMPLE_TOKENS)
    torch.cuda.synchronize()
    upsample_s = time.perf_counter() - t0
    again = upsample_prompt(encoder, head, ID_PROMPT, temperature=0.0, max_new_tokens=ID_UPSAMPLE_TOKENS)
    if not upsampled or upsampled != again:
        raise RuntimeError(f"ideogram enhancer: {upsampled!r} then {again!r}")
    enhancer = {"head": [trunk_cfg.hidden_size, trunk_cfg.vocab_size], "head_gb_f32": head.numel() * 4 / 1e9,
                "new_tokens": ID_UPSAMPLE_TOKENS, "temperature": 0.0, "s": upsample_s,
                "s_per_token": upsample_s / ID_UPSAMPLE_TOKENS, "words": len(upsampled.split()),
                "greedy_repeatable": True}
    del head, encoder, trunk, family
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the import, bitwise
    model = ModelRegistry.create("ideogram", config_namespace(values))
    if model.arch != arch:
        raise RuntimeError(f"ideogram: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()
    imported = _import_bitwise(model, module, id_dir, weights, ideogram_params_from_checkpoint, file_bytes)
    params = sum(math.prod(v) for v in ideogram_checkpoint_shapes(full).values())
    del weights

    # (f) the parity forward (segment ids 0 / 1) and (g) the CFG sampler loop, no decode
    id_key = f"18x{ID_JOINT}x{ID_JOINT}x256"
    keys = {id_key: ID_FILE_BLOCKS}
    noise = torch.randn((1, latent, latent, 32), generator=gen, device=dev)
    launches = _forward_launches(model, module, batch, kernels, ID_SIGMA)
    if launches["flash_fwd"] != keys:
        raise RuntimeError(f"ideogram forward: launches by shape {launches}")
    parity = {**_parity_forward(model, module, batch, noise, ID_SIGMA), "tokens": ID_JOINT,
              "text_valid": text["caption_valid"], "launches_by_shape": launches}
    sampler = _cfg_sampler(model, module, batch, negative, kernels, ID_GUIDANCE, (1, latent, latent, 32), gen, keys)
    del module, model, negative
    gc.collect()
    torch.cuda.empty_cache()

    # (h) 6 graphed rank-16 LoRA steps on an int8 base through build_train_step
    train_model = Ideogram(config_namespace(_graph_train_values("ideogram", ID_TRAIN_STEPS)))
    with torch.device(dev):
        train_module = load_transformer_params(train_model, init_adapters(train_model.create_module(), gen), id_dir)
    train_batch = {**batch, "latents": torch.randn((1, latent, latent, 32), generator=gen, device=dev)}
    step_keys = {id_key: (ID_FILE_BLOCKS, True)}
    train = _graph_vs_eager(train_model, train_module, train_batch, kernels, ID_TRAIN_STEPS,
                            _totals(_by_shape_per_step(step_keys)), ideogram_step_flops(arch, 1, LC_IMG, ID_TEXT))
    by_shape = train["launches_per_step_by_shape"]
    if by_shape != _by_shape_per_step(step_keys):
        raise RuntimeError(f"ideogram train: launches per step by shape {by_shape}")
    train.update({"base": "int8", "quantized_matmul": "full", "remat": "every layer", "lora_rank": 16,
                  "lora_targets": "every adapter-carrying linear (the JAX family's default)",
                  "flop_checks": flop_checks})
    del train_module, train_model
    gc.collect()
    torch.cuda.empty_cache()

    # (i) in a run that names the phase: all 34 layers built in memory, graphed
    full_depth = None
    if full_in_memory:
        deep = Ideogram(config_namespace(_graph_train_values("ideogram", ID_TRAIN_STEPS)), arch=full)
        deep_keys = {id_key: (full.num_layers, True)}
        full_depth = _graph_vs_eager(deep, _drawn_in_memory(deep, gen), train_batch, kernels, ID_TRAIN_STEPS,
                                     _totals(_by_shape_per_step(deep_keys)),
                                     ideogram_step_flops(full, 1, LC_IMG, ID_TEXT))
        if full_depth["launches_per_step_by_shape"] != _by_shape_per_step(deep_keys):
            raise RuntimeError(f"ideogram 34 layers: launches per step by shape "
                               f"{full_depth['launches_per_step_by_shape']}")
        full_depth.update({"blocks": [full.num_layers, full.num_layers], "base": "int8 (built in memory)",
                           "quantized_matmul": "full", "remat": "every layer", "lora_rank": 16})
        del deep
        gc.collect()
        torch.cuda.empty_cache()
    del batch, train_batch
    shutil.rmtree(id_dir, ignore_errors=True)
    phase("41 ideogram", config="ideogram-ai/ideogram-v3-fp8 transformer/ as the JAX preset IdeogramConfig() builds it",
          params=params, params_per_layer=sum(math.prod(v) for k, v in shapes.items() if k.startswith("layers.0.")),
          hidden=full.emb_dim, heads=[full.num_heads, full.head_dim],
          depth={"file": [ID_FILE_BLOCKS, full.num_layers], "train": [ID_FILE_BLOCKS, full.num_layers],
                 "in_memory": [full.num_layers if full_in_memory else 0, full.num_layers],
                 "trunk": [ID_TRUNK_LAYERS, 36]},
          tokens={"text": ID_TEXT, "image": LC_IMG, "joint": ID_JOINT}, latent_channels=32, files=files,
          text_encoder=text, enhancer=enhancer, imported=imported, parity=parity, sampler=sampler, train=train,
          full_depth=full_depth, allocated_gib_before_phase=baseline_gib, seconds=time.perf_counter() - start,
          device=device)
    return {"id_joint": {k: v.get(id_key, 0) for k, v in by_shape.items()}}


def longcat_video_flops(arch, batch: int, tokens: int, text_tokens: int, frames: int) -> tuple:
    """Model FLOPs of one LongCat-Video forward as (the adapted part, the
    rest): per block the fused qkv, the projections, ``crs_q``, the SwiGLU
    and both attentions' two products; ``final_linear``; then the framewise
    AdaLN heads of every block and of the final layer, each block's
    ``crs_kv`` over the text, the patch embed, the time MLP and the caption
    MLP, whose inputs carry no gradient."""
    d, f, temb = arch.hidden_size, arch.ffn_hidden, arch.adaln_tembed_dim
    s, text, patch = tokens, text_tokens, math.prod(arch.patch_size)
    block = s * (12 * d * d + 6 * d * f) + 4 * s * s * d + 4 * s * text * d
    trained = arch.depth * block + 2 * s * d * patch * arch.out_channels
    frozen = arch.depth * (12 * frames * temb * d + 4 * text * d * d) + 2 * s * patch * arch.in_channels * d \
        + 2 * arch.frequency_embedding_size * temb + 2 * temb * temb + 2 * text * arch.caption_channels * d \
        + 2 * text * d * d + 4 * frames * temb * d
    return batch * trained, batch * frozen


def longcat_video_step_flops(arch, batch: int, tokens: int, text_tokens: int, frames: int) -> int:
    """Model FLOPs of one LongCat-Video train step (the adapted part x 3, the rest once)."""
    trained, frozen = longcat_video_flops(arch, batch, tokens, text_tokens, frames)
    return 3 * trained + frozen


def sana_flops(arch, batch: int, tokens: int, text_tokens: int) -> tuple:
    """Model FLOPs of one Sana forward as (the adapted part, the rest): the
    patch dense and the caption MLP (both adapted), per block the linear
    attention's projections and its three products, the cross-attention's
    projections and two products, the Mix-FFN's 1 x 1 convs and depthwise 3
    x 3, ``final_proj``; then the time MLP and ``time_proj``, which take no
    gradient input."""
    d, s, text = arch.hidden_size, tokens, text_tokens
    inner, head = arch.self_heads * arch.self_head_dim, arch.self_head_dim
    cross, hidden = arch.cross_heads * arch.cross_head_dim, int(d * arch.ffn_ratio)
    features = arch.patch_size ** 2 * arch.in_channels
    block = (6 * s * d * inner + 4 * s * inner * head + 2 * s * inner + 2 * s * inner * d + 2 * s * d * cross
             + 4 * text * d * cross + 4 * s * text * cross + 2 * s * cross * d + 6 * s * d * hidden + 36 * s * hidden)
    trained = arch.depth * block + 4 * s * features * d + 2 * text * arch.text_dim * d + 2 * text * d * d
    frozen = 2 * 256 * d + 2 * d * d + 12 * d * d
    return batch * trained, batch * frozen


def sana_step_flops(arch, batch: int, tokens: int, text_tokens: int) -> int:
    """Model FLOPs of one Sana train step (the adapted part x 3, the rest once)."""
    trained, frozen = sana_flops(arch, batch, tokens, text_tokens)
    return 3 * trained + frozen


def sanavideo_flops(arch, batch: int, tokens: int, text_tokens: int) -> tuple:
    """Model FLOPs of one Sana-Video forward as (the adapted part, the
    rest): per block the linear attention's projections and its three
    products, ``attn2_q``, the cross-attention's two products and
    projection, GLUMBTempConv's 1 x 1 convs, depthwise 3 x 3 and (3, 1)
    temporal conv; ``proj_out``; then each block's ``attn2_k`` / ``attn2_v``
    over the text, the patch embed, AdaLayerNormSingle and the caption MLP,
    whose inputs carry no gradient."""
    d, s, text, head = arch.hidden_size, tokens, text_tokens, arch.head_dim
    cross, hidden, patch = arch.cross_heads * arch.cross_head_dim, int(arch.mlp_ratio * d), math.prod(arch.patch_size)
    block = (8 * s * d * d + 4 * s * d * head + 2 * s * d + 2 * s * d * cross + 4 * s * text * cross
             + 2 * s * cross * d + 6 * s * d * hidden + 36 * s * hidden + 6 * s * d * d)
    trained = arch.num_layers * block + 2 * s * d * patch * arch.out_channels
    frozen = arch.num_layers * 4 * text * d * cross + 2 * s * patch * arch.in_channels * d + 2 * 256 * d \
        + 2 * d * d + 12 * d * d + 2 * text * arch.caption_channels * d + 2 * text * d * d
    return batch * trained, batch * frozen


def sanavideo_step_flops(arch, batch: int, tokens: int, text_tokens: int) -> int:
    """Model FLOPs of one Sana-Video train step (the adapted part x 3, the rest once)."""
    trained, frozen = sanavideo_flops(arch, batch, tokens, text_tokens)
    return 3 * trained + frozen


def _linear_attention_ms(heads: int, tokens: int, head_dim: int, rope: bool) -> dict:
    """One block's linear self-attention at full width on the card (bf16
    projections in, f32 products, no kernel): Sana's ``relu_linear_attention``
    or Sana-Video's (ReLU, RoPE, the unrotated normaliser), the forward's ms."""
    import torch

    from simpletuner_tpu_torch.models.sana import relu_linear_attention
    from simpletuner_tpu_torch.models.sanavideo.transformer import rope_linear_attention

    gen = torch.Generator(device="cuda").manual_seed(tokens)
    q, k, v = (torch.randn((1, tokens, heads, head_dim), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    if not rope:
        return {"shape": [1, tokens, heads, head_dim], "ms": cuda_ms(lambda: relu_linear_attention(q, k, v), 10)}
    cos, sin = (torch.randn((tokens, head_dim), generator=gen, device="cuda") for _ in range(2))
    return {"shape": [1, tokens, heads, head_dim], "rope": True, "ms": cuda_ms(
        lambda: rope_linear_attention(torch.relu(q).float(), torch.relu(k).float(), v.float(), cos, sin), 10)}


def write_gemma_trunk(root: str, layers: int, gen) -> float:
    """Gemma-2 2B (``gemma2_2b``: 2304 wide, 8 heads of 256, 4 kv heads,
    256,000 tokens) at ``layers`` of its 26 in the HF layout (e4m3) with its
    ``config.json``; returns the write seconds."""
    from simpletuner_tpu_torch.models.llm_encoder import LLMEncoderConfig

    config = dataclasses.replace(LLMEncoderConfig.gemma2_2b(), num_layers=layers)
    return write_llm_trunk(root, config, gen, {
        "architectures": ["Gemma2Model"], "model_type": "gemma2", "query_pre_attn_scalar": 256,
        "attn_logit_softcapping": 50.0, "hidden_activation": "gelu_pytorch_tanh"})


def _video_trainer_check(trainer, arch, family: str, latent_shape: tuple, clips: int, text: int) -> dict:
    """A video family's ``Trainer.run()``: its arch, one clip bucket of
    ``clips`` cached latents of ``latent_shape`` (the Wan-config video VAE at
    16 channels), the batch's text and mask shapes, an int8 base, then a
    replay against an eager step (``_graph_matches_eager``)."""
    import numpy as np

    from simpletuner_tpu_torch.models.video_vae import VideoAutoencoderKL, VideoVAEConfig

    bundle = trainer.data_plane.bundles["clips"]
    buckets = sorted(bundle.metadata_backend.aspect_ratio_bucket_indices)
    paths = [p for key in buckets for p in bundle.metadata_backend.aspect_ratio_bucket_indices[key]]
    cached = [bundle.vae_cache.load(p) for p in paths]
    batch = trainer._example_batch()
    shapes = {k: tuple(v.shape) for k, v in batch.items() if k.startswith("text")}
    if trainer.model.arch != arch or len(buckets) != 1 or len(paths) != clips or \
            not isinstance(trainer.vae, VideoAutoencoderKL) or trainer.vae.config != VideoVAEConfig.wan() or \
            any(c.shape != latent_shape + (16,) or not np.isfinite(c).all() for c in cached) or \
            trainer.model.base_precision != "int8" or \
            shapes != {"text_embeds": (1, text, shapes["text_embeds"][-1]), "text_attention_mask": (1, text)}:
        raise RuntimeError(f"{family} trainer: arch {trainer.model.arch}, buckets {buckets}, VAE {trainer.vae.config}, "
                           f"cached {[c.shape for c in cached]}, base {trainer.model.base_precision}, batch {shapes}")
    startup = trainer.data_plane.startup_metrics
    return {"buckets": buckets, "latents": list(cached[0].shape), "caption_valid": int(batch["text_attention_mask"].sum()),
            "cache": {"text_s": startup.get("text_cache_clips_s"), "vae_s": startup.get("vae_cache_clips_s")},
            **_graph_matches_eager(trainer, ("loss", "grad_norm"))}


def video_dit_phase(number: int, family: str, paths: dict, kernels, device: str, full_in_memory: bool) -> dict:
    """Phases 42 and 44: LongCat-Video (``family`` "longcat_video") or
    Sana-Video ("sanavideo") at the JAX preset's full width on 832 x 480 x 81
    clips (21 x 30 x 52 = 32,760 tokens): a seeded e4m3 checkpoint at
    ``LV_FILE_BLOCKS`` / ``SV_FILE_BLOCKS`` of the published depth beside its
    text encoder (phase 15's T5-XXL and tokenizer linked; phase 43's Gemma-2
    and tokenizer linked, written here in a run without them); two seeded
    clips (Sana-Video links phase 42's with their cached latents); the import
    held bitwise; ``Trainer.run()``: the text cache, the video VAE cache one
    clip at a time, 6 graphed rank-16 LoRA steps on an int8 base
    (``quantized_matmul`` full) with every block checkpointed, a replay
    bitwise against an eager step and the profiled replay held to the
    capture's launches by shape; a true-CFG mp4 render at 480 px square;
    one forward with the kernels against the plain attention on a 17-frame
    clip with the padded caption; in a run that names the phase, every block
    built in memory on an int8 base and its graphed step timed.  Returns the
    launches per step of each kernel at the family's shapes."""
    import gc

    import torch

    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models import checkpoint_layouts, weight_import
    from simpletuner_tpu_torch.models.longcat_video import LongcatVideo, LongCatVideoConfig, LongCatVideoTransformer
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.sanavideo import SanaVideo, SanaVideoConfig, SanaVideoTransformer

    start = time.perf_counter()
    work = paths["work"]
    longcat = family == "longcat_video"
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(number)
    latent_shape = (WAN_FRAMES - 1) // 4 + 1, WAN_HEIGHT // 8, WAN_WIDTH // 8
    text_len, valid_case = (LV_TEXT, LV_VALID) if longcat else (SV_TEXT, SV_VALID)
    if longcat:
        cls, module_cls, full, file_blocks = LongcatVideo, LongCatVideoTransformer, LongCatVideoConfig(), LV_FILE_BLOCKS
        if (full.hidden_size, full.depth, full.num_heads, full.head_dim, full.ffn_hidden, full.caption_channels) != \
                (4096, 48, 32, 128, 11008, 4096):
            raise RuntimeError(f"not the JAX preset of LongCat-Video: {full}")
        arch, depth_field = dataclasses.replace(full, depth=file_blocks), "depth"
        tiny = LongCatVideoConfig.tiny()
        wider = dataclasses.replace(tiny, hidden_size=32, num_heads=2, caption_channels=24, depth=1)
        flop_checks = _flop_checks(_x3(longcat_video_flops), module_cls, [
            (a, (torch.zeros(2, t, h, w, a.in_channels), torch.full((2,), 500.0), torch.zeros(2, txt, a.caption_channels),
                 torch.ones(2, txt, dtype=torch.int32)), (t * h * w // 4, txt, t))
            for a, (t, h, w), txt in ((tiny, (2, 4, 6), 5), (wider, (3, 2, 4), 3))])
        step_flops = lambda a: longcat_video_step_flops(a, 1, WAN_TOKENS, text_len, latent_shape[0])  # noqa: E731
        heads = full.num_heads
        layout, from_checkpoint = checkpoint_layouts.longcat_video_checkpoint_shapes, \
            weight_import.longcat_video_params_from_checkpoint
        prompt, guidance, sigma = LV_PROMPT, LV_GUIDANCE, LV_SIGMA
        config_name = "meituan-longcat/LongCat-Video as the JAX preset LongCatVideoConfig() builds it"
    else:
        cls, module_cls, full, file_blocks = SanaVideo, SanaVideoTransformer, SanaVideoConfig(), SV_FILE_BLOCKS
        if (full.hidden_size, full.num_layers, full.num_heads, full.head_dim, full.cross_heads,
                full.caption_channels) != (2240, 20, 20, 112, 20, 2304):
            raise RuntimeError(f"not the JAX preset of Sana-Video: {full}")
        arch, depth_field = dataclasses.replace(full, num_layers=file_blocks), "num_layers"
        tiny = dataclasses.replace(SanaVideoConfig.tiny(), head_dim=16, cross_head_dim=16)
        wider = dataclasses.replace(tiny, num_heads=3, cross_heads=3, num_layers=1, caption_channels=24)
        flop_checks = _flop_checks(_x3(sanavideo_flops), module_cls, [
            (a, (torch.zeros(2, t, h, w, a.in_channels), torch.full((2,), 500.0), torch.zeros(2, txt, a.caption_channels),
                 torch.ones(2, txt, dtype=torch.int32)), (t * h * w // 4, txt))
            for a, (t, h, w), txt in ((tiny, (2, 4, 6), 5), (wider, (3, 2, 4), 3))])
        step_flops = lambda a: sanavideo_step_flops(a, 1, WAN_TOKENS, text_len)  # noqa: E731
        heads = full.cross_heads
        layout, from_checkpoint = checkpoint_layouts.sanavideo_checkpoint_shapes, \
            weight_import.sanavideo_params_from_checkpoint
        prompt, guidance, sigma = SV_PROMPT, SV_GUIDANCE, SV_SIGMA
        config_name = "Efficient-Large-Model/SANA-Video_2B_480p transformer/ as the JAX preset SanaVideoConfig() builds it"
    depth = getattr(arch, depth_field)
    shapes = layout(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 8e9 or written_before + file_bytes / 1e9 + 0.2 + _reserved(number) > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"{family}: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the phase; "
                           f"it and the later phases write {file_bytes / 1e9 + 0.2 + _reserved(number):.1f} GB of the "
                           f"{RUN_WRITE_TARGET_GB} GB a run may write")

    # (b) the seeded transformer (two e4m3 shards), the text encoder linked
    # (or written), the clips written (or linked with their cached latents)
    root = os.path.join(work, family)
    weights, write_s = _write_e4m3_transformer(root, shapes, gen)
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "blocks": [depth, getattr(full, depth_field)]}
    data, cache = os.path.join(work, f"{family}_data"), os.path.join(work, f"{family}_cache")
    if longcat:
        for source, target in (("text_encoder_2", "text_encoder"), ("tokenizer_2", "tokenizer_2")):
            _link_tree(os.path.join(paths["flux_dir"], source), os.path.join(root, target))
        files["t5_xxl"] = {"linked_from_phase": 15, "blocks": [T5_FILE_LAYERS, 24]}
        files.update(_write_clips(data, LV_CLIPS, WAN_FRAMES, WAN_HEIGHT, WAN_WIDTH, 16, 42))
        paths["lv_clips"] = data
    else:
        gemma = paths.get("gemma_root")
        if gemma and os.path.isdir(gemma):
            for sub in ("text_encoder", "tokenizer"):
                _link_tree(os.path.join(gemma, sub), os.path.join(root, sub))
            files["gemma2"] = {"linked_from_phase": 43, "layers": [GEMMA_FILE_LAYERS, 26]}
        else:
            files["gemma2"] = {"written_by_phase": number, "layers": [GEMMA_FILE_LAYERS, 26], "write_s":
                               write_gemma_trunk(os.path.join(root, "text_encoder"), GEMMA_FILE_LAYERS, gen)}
            write_gemma_tokenizer(os.path.join(root, "tokenizer"), " ".join(TRAIN_CAPTIONS + [prompt]).split())
        clips = paths.get("lv_clips")
        if clips and os.path.isdir(clips):
            _link_tree(clips, data)
            _link_tree(os.path.join(work, "longcat_video_cache", "vae"), os.path.join(cache, "vae"))
            files["clips"] = {"linked_from_phase": 42, "with_vae_latents": True}
        else:
            files.update(_write_clips(data, LV_CLIPS, WAN_FRAMES, WAN_HEIGHT, WAN_WIDTH, 16, 42))
    files.update({"written_gb_before": written_before, "written_gb_after": _written_gb(), "free_gb_before": free / 1e9})

    # (c) the import, bitwise
    model = ModelRegistry.create(family, config_namespace({"model_family": family, "model_type": "full"}))
    if model.arch != arch:
        raise RuntimeError(f"{family}: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()
    imported = _import_bitwise(model, module, root, weights, from_checkpoint, file_bytes)
    params = sum(math.prod(v) for v in layout(full).values())
    del weights, module, model
    gc.collect()
    torch.cuda.empty_cache()

    # (d) Trainer.run() on the clips: rank-16 LoRA on an int8 base, every block checkpointed
    self_key, cross_key = f"{heads}x{WAN_TOKENS}x{WAN_TOKENS}x128", f"{heads}x{WAN_TOKENS}x{text_len}x{112 if not longcat else 128}"
    keys = {cross_key: (depth, True)}
    if longcat:
        keys[self_key] = (depth, True)
    config = _video_config(family, root, data, cache, os.path.join(work, f"{family}_train"), WAN_FRAMES,
                           LV_TRAIN_STEPS if longcat else SV_TRAIN_STEPS, base_model_precision="int8-quanto",
                           quantized_matmul="full")
    train = _train_graphed(config, kernels, LV_TRAIN_STEPS if longcat else SV_TRAIN_STEPS,
                           _totals(_by_shape_per_step(keys)), step_flops(arch),
                           lambda trainer: _video_trainer_check(trainer, arch, family, latent_shape, LV_CLIPS, text_len))
    by_shape = train["launches_per_step_by_shape"]
    if by_shape != _by_shape_per_step(keys):
        raise RuntimeError(f"{family} trainer: launches per step by shape {by_shape}")
    train.update({"base": "int8", "quantized_matmul": "full", "remat": "every block", "lora_rank": 16,
                  "lora_targets": "every adapter-carrying linear (no code reads DEFAULT_LORA_TARGET)",
                  "flop_checks": flop_checks})

    # (e) the mp4 render at 480 px square; (f) the parity forward on a 17-frame clip
    per_forward = 2 * depth if longcat else depth
    render, runtime = _video_render(work, family, root, family, kernels, prompt, guidance, WAN_RENDER_SIZE,
                                    LV_RENDER_FRAMES, per_forward)
    module, model = runtime.module, runtime.model
    if model.arch != arch or model.NAME != family:
        raise RuntimeError(f"{family}: the runtime built {model.NAME} {model.arch}")
    render["tokens"] = ((LV_RENDER_FRAMES - 1) // 4 + 1) * (WAN_RENDER_SIZE // 16) ** 2
    parity_latent = ((LV_PARITY_FRAMES - 1) // 4 + 1, latent_shape[1], latent_shape[2])
    batch = _text_batch(model, prompt, (1,) + parity_latent + (16,), dev)
    caption_valid = int(batch["text_attention_mask"].sum())
    if tuple(batch["text_embeds"].shape[:2]) != (1, text_len) or not 1 < caption_valid < text_len:
        raise RuntimeError(f"{family} parity: the caption {tuple(batch['text_embeds'].shape)}, {caption_valid} valid")
    model.text_encoders = []  # the plain attention's scores need the room
    gc.collect()
    torch.cuda.empty_cache()
    noise = torch.randn((1,) + parity_latent + (16,), generator=gen, device=dev)
    parity = {**_parity_forward(model, module, batch, noise, sigma), "frames": LV_PARITY_FRAMES,
              "tokens": math.prod(parity_latent) // 4, "caption_valid": caption_valid}
    train_batch = {"latents": torch.randn((1,) + latent_shape + (16,), generator=gen, device=dev),
                   "text_embeds": torch.randn((1, text_len, batch["text_embeds"].shape[-1]), generator=gen, device=dev),
                   "text_attention_mask": (torch.arange(text_len, device=dev) < caption_valid)[None].to(torch.int32)}
    del runtime, module, model, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (g) in a run that names the phase: every block built in memory, int8, graphed
    full_depth = None
    if full_in_memory:
        deep = cls(config_namespace(_graph_train_values(family, LV_FULL_STEPS)), arch=full)
        deep_keys = {k: (getattr(full, depth_field), grad) for k, (_, grad) in keys.items()}
        full_depth = _graph_vs_eager(deep, _drawn_in_memory(deep, gen), train_batch, kernels, LV_FULL_STEPS,
                                     _totals(_by_shape_per_step(deep_keys)), step_flops(full))
        if full_depth["launches_per_step_by_shape"] != _by_shape_per_step(deep_keys):
            raise RuntimeError(f"{family} full depth: launches per step by shape "
                               f"{full_depth['launches_per_step_by_shape']}")
        full_depth.update({"blocks": [getattr(full, depth_field)] * 2, "base": "int8 (built in memory)",
                           "quantized_matmul": "full", "remat": "every block", "lora_rank": 16})
        del deep
        gc.collect()
        torch.cuda.empty_cache()
    del train_batch
    shutil.rmtree(os.path.join(work, f"{family}_train"), ignore_errors=True)
    shutil.rmtree(os.path.join(work, f"{family}_render"), ignore_errors=True)
    linear = None
    if not longcat:
        linear = _linear_attention_ms(full.num_heads, WAN_TOKENS, full.head_dim, rope=True)
        # disk space; phase 46 links sana's Gemma-2, phase 48 the clips and their latents
        for name in ("sanavideo", "sanavideo_data", "sanavideo_cache", "longcat_video",
                     os.path.join("sana", "transformer") if _runs(46) else "sana") + \
                (() if _runs(48) else ("longcat_video_data", "longcat_video_cache")):
            shutil.rmtree(os.path.join(work, name), ignore_errors=True)
    phase(f"{number} {family}", config=config_name, params=params,
          params_per_block=sum(math.prod(v) for k, v in shapes.items() if k.startswith(("blocks.0.", "transformer_blocks.0."))),
          hidden=full.hidden_size, heads=[heads, 128 if longcat else full.cross_head_dim],
          depth={"file": [depth, getattr(full, depth_field)], "train": [depth, getattr(full, depth_field)],
                 "in_memory": [getattr(full, depth_field) if full_in_memory else 0, getattr(full, depth_field)]},
          clip=[WAN_FRAMES, WAN_HEIGHT, WAN_WIDTH], latents=list(latent_shape),
          tokens={"video": WAN_TOKENS, "text": text_len}, files=files, imported=imported, train=train, render=render,
          parity=parity, full_depth=full_depth, linear_attention=linear, allocated_gib_before_phase=baseline_gib,
          seconds=time.perf_counter() - start, device=device)
    out = {"sv_cross" if not longcat else "lv_cross": {k: v.get(cross_key, 0) for k, v in by_shape.items()}}
    if longcat:
        out["lv_self"] = {k: v.get(self_key, 0) for k, v in by_shape.items()}
    return out


def sana_phase(paths: dict, kernels, device: str, full_in_memory: bool) -> dict:
    """Phase 43: Sana 1600M at the JAX preset's full width (``SanaConfig()``):
    a seeded e4m3 checkpoint at ``SA_FILE_BLOCKS`` of its 20 blocks, a seeded
    Gemma-2 2B at ``GEMMA_FILE_LAYERS`` of 26 (e4m3; phase 44 links it) and a
    word-level tokenizer: 16 prompts at 300 tokens through the ``gemma``
    spec (prompts/s, bf16 against f32); the import held bitwise; one forward
    against the plain attention (the unmasked cross-attention at head dim
    112, Gemma's pads attended); the flow Euler loop with true CFG over
    32-channel latents at 1024 px, without a decode; 6 graphed LoRA steps on
    an int8 base through ``build_train_step`` (the 32-channel wall stops
    ``Trainer.run()`` in both packages); the linear attention's time per
    block at full width; in a run that names the phase, all 20 blocks in
    memory and their graphed step timed.  Returns the launches per step of
    each kernel at the cross-attention's shape."""
    import gc

    import torch

    from simpletuner_tpu_torch.bench_cache import prompts_for
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import sana_checkpoint_shapes
    from simpletuner_tpu_torch.models.layers import init_adapters
    from simpletuner_tpu_torch.models.llm_encoder import LLMEncoderConfig
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.sana import Sana, SanaConfig, SanaTransformer
    from simpletuner_tpu_torch.models.vae import VAEConfig
    from simpletuner_tpu_torch.models.weight_import import load_transformer_params, sana_params_from_diffusers

    start = time.perf_counter()
    work = paths["work"]
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    tiny = SanaConfig.tiny()
    wider = dataclasses.replace(tiny, hidden_size=48, self_heads=3, cross_heads=3, cross_head_dim=16, text_dim=24,
                                depth=1)
    flop_checks = _flop_checks(_x3(sana_flops), SanaTransformer, [
        (arch, (torch.zeros(2, h, w, arch.in_channels), torch.full((2,), 0.5), torch.zeros(2, txt, arch.text_dim)),
         (h * w, txt)) for arch, (h, w), txt in ((tiny, (4, 6), 5), (wider, (3, 5), 3))])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(43)
    full = SanaConfig()
    if (full.hidden_size, full.depth, full.self_heads, full.self_head_dim, full.cross_heads, full.cross_head_dim,
            full.in_channels, full.text_dim, int(full.hidden_size * full.ffn_ratio)) != \
            (2240, 20, 70, 32, 20, 112, 32, 2304, 5600):
        raise RuntimeError(f"not the JAX preset of Sana 1600M: {full}")
    arch = dataclasses.replace(full, depth=SA_FILE_BLOCKS)
    shapes = sana_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 6e9 or written_before + PHASE43_WRITE_GB + _reserved(43) > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"sana: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the phase; "
                           f"it and the later phases write {PHASE43_WRITE_GB + _reserved(43):.1f} GB of the "
                           f"{RUN_WRITE_TARGET_GB} GB a run may write")

    # (b) the seeded transformer (two e4m3 shards), Gemma-2 and a word-level tokenizer
    sa_dir = os.path.join(work, "sana")
    weights, write_s = _write_e4m3_transformer(sa_dir, shapes, gen)
    gemma_write_s = write_gemma_trunk(os.path.join(sa_dir, "text_encoder"), GEMMA_FILE_LAYERS, gen)
    paths["gemma_root"] = sa_dir  # phase 44 links it
    prompts = [f"{TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]}, {p}" for i, p in enumerate(prompts_for(TEXT_PROMPTS))]
    write_gemma_tokenizer(os.path.join(sa_dir, "tokenizer"), " ".join(TRAIN_CAPTIONS + [SA_PROMPT, SV_PROMPT] +
                                                                      prompts).split())
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "blocks": [SA_FILE_BLOCKS, full.depth],
             "gemma2": {"layers": [GEMMA_FILE_LAYERS, 26], "write_s": gemma_write_s, "dtype": "float8_e4m3fn"},
             "written_gb_before": written_before, "written_gb_after": _written_gb(), "free_gb_before": free / 1e9}

    # (c) the prompts at 300 tokens through the gemma spec
    gemma = dataclasses.replace(LLMEncoderConfig.gemma2_2b(), num_layers=GEMMA_FILE_LAYERS)
    encoder, text = _encoder_and_report(Sana.TEXT_ENCODER_CONFIGURATION[0], sa_dir, gemma, SA_TEXT, prompts)
    values = {"model_family": "sana", "model_type": "full", "mixed_precision": "bf16"}
    family = Sana(config_namespace(values))
    family.attach_text_encoders([encoder])
    latent = RESOLUTION // 32
    batch = _text_batch(family, SA_PROMPT, (1, latent, latent, 32), dev)
    negative = _text_batch(family, "", (1, latent, latent, 32), dev)
    if {k: tuple(v.shape) for k, v in batch.items()} != {"latents": (1, latent, latent, 32),
                                                         "text_embeds": (1, SA_TEXT, 2304)}:
        raise RuntimeError(f"sana: the collated batch {({k: tuple(v.shape) for k, v in batch.items()})}")
    text["caption_valid"] = int(encoder.encode([SA_PROMPT])["attention_mask"][0].sum())
    del encoder, family
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the import, bitwise
    model = ModelRegistry.create("sana", config_namespace(values))
    if model.arch != arch:
        raise RuntimeError(f"sana: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()
    imported = _import_bitwise(model, module, sa_dir, weights, sana_params_from_diffusers, file_bytes)
    params = sum(math.prod(v) for v in sana_checkpoint_shapes(full).values())
    del weights

    # (e) the parity forward (the caption unmasked, as the family collates it) and (f) the CFG sampler loop
    sa_key = f"20x{SA_IMG}x{SA_TEXT}x112"
    keys = {sa_key: SA_FILE_BLOCKS}
    noise = torch.randn((1, latent, latent, 32), generator=gen, device=dev)
    launches = _forward_launches(model, module, batch, kernels, SA_SIGMA)
    if launches["flash_fwd"] != keys:
        raise RuntimeError(f"sana forward: launches by shape {launches}")
    parity = {**_parity_forward(model, module, batch, noise, SA_SIGMA), "tokens": SA_IMG, "keys": SA_TEXT,
              "text_valid": text["caption_valid"], "launches_by_shape": launches}
    sampler = _cfg_sampler(model, module, batch, negative, kernels, SA_GUIDANCE, (1, latent, latent, 32), gen, keys)
    del module, model, negative
    gc.collect()
    torch.cuda.empty_cache()

    # (g) 6 graphed rank-16 LoRA steps on an int8 base, every block checkpointed,
    # through build_train_step (both trainers stop at the 32-channel wall)
    wall = {"latent_channels": Sana.LATENT_CHANNEL_COUNT, "trainer_vae_channels": VAEConfig.flux().latent_channels,
            "patch_in_features": full.patch_size ** 2 * full.in_channels}
    if (wall["latent_channels"], wall["trainer_vae_channels"]) != (32, 16):
        raise RuntimeError(f"sana: the 32-channel wall moved: {wall}")
    train_model = Sana(config_namespace(_graph_train_values("sana", SA_TRAIN_STEPS)))
    with torch.device(dev):
        train_module = load_transformer_params(train_model, init_adapters(train_model.create_module(), gen), sa_dir)
    train_batch = {**batch, "latents": torch.randn((1, latent, latent, 32), generator=gen, device=dev)}
    step_keys = {sa_key: (SA_FILE_BLOCKS, True)}
    train = _graph_vs_eager(train_model, train_module, train_batch, kernels, SA_TRAIN_STEPS,
                            _totals(_by_shape_per_step(step_keys)), sana_step_flops(arch, 1, SA_IMG, SA_TEXT))
    by_shape = train["launches_per_step_by_shape"]
    if by_shape != _by_shape_per_step(step_keys):
        raise RuntimeError(f"sana train: launches per step by shape {by_shape}")
    train.update({"base": "int8", "quantized_matmul": "full", "remat": "every block", "lora_rank": 16,
                  "lora_targets": "every adapter-carrying linear (the caption MLP's too)", "wall": wall,
                  "flop_checks": flop_checks})
    del train_module, train_model
    gc.collect()
    torch.cuda.empty_cache()

    # (h) in a run that names the phase: all 20 blocks built in memory, graphed
    full_depth = None
    if full_in_memory:
        deep = Sana(config_namespace(_graph_train_values("sana", SA_TRAIN_STEPS)), arch=full)
        deep_keys = {sa_key: (full.depth, True)}
        full_depth = _graph_vs_eager(deep, _drawn_in_memory(deep, gen), train_batch, kernels, SA_TRAIN_STEPS,
                                     _totals(_by_shape_per_step(deep_keys)), sana_step_flops(full, 1, SA_IMG, SA_TEXT))
        if full_depth["launches_per_step_by_shape"] != _by_shape_per_step(deep_keys):
            raise RuntimeError(f"sana 20 blocks: launches per step by shape {full_depth['launches_per_step_by_shape']}")
        full_depth.update({"blocks": [full.depth, full.depth], "base": "int8 (built in memory)",
                           "quantized_matmul": "full", "remat": "every block", "lora_rank": 16})
        del deep
        gc.collect()
        torch.cuda.empty_cache()
    del batch, train_batch
    linear = _linear_attention_ms(full.self_heads, SA_IMG, full.self_head_dim, rope=False)
    phase("43 sana", config="Efficient-Large-Model/Sana_1600M_1024px_diffusers transformer/ as the JAX preset "
          "SanaConfig() builds it", params=params,
          params_per_block=sum(math.prod(v) for k, v in shapes.items() if k.startswith("transformer_blocks.0.")),
          hidden=full.hidden_size, heads={"linear": [full.self_heads, full.self_head_dim],
                                          "cross": [full.cross_heads, full.cross_head_dim]},
          depth={"file": [SA_FILE_BLOCKS, full.depth], "train": [SA_FILE_BLOCKS, full.depth],
                 "in_memory": [full.depth if full_in_memory else 0, full.depth]},
          tokens={"image": SA_IMG, "text": SA_TEXT}, latent_channels=32, files=files, text_encoder=text,
          imported=imported, parity=parity, sampler=sampler, train=train, full_depth=full_depth,
          linear_attention=linear, allocated_gib_before_phase=baseline_gib, seconds=time.perf_counter() - start,
          device=device)
    return {"sa_cross": {k: v.get(sa_key, 0) for k, v in by_shape.items()}}


def cosmos3_flops(arch, batch: int, gen_tokens: int, und_tokens: int) -> tuple:
    """Model FLOPs of one Cosmos3 forward as (the part a gradient runs
    through with the default ``attn_gen_*`` adapters, the rest): per layer
    the generation pathway's q / k / v / out and SwiGLU over the generation
    tokens and its attention's two products against [und, gen] keys, then
    ``proj_out``; the rest once: ``proj_in``, the per-token time MLP, the
    understanding pathway (its linears and the causal block's two products,
    which the plain block computes over every (query, key) pair) and
    ``lm_head``."""
    d, hd, ffn = arch.hidden_size, arch.head_dim, arch.intermediate_size
    q_out, kv_out = arch.num_heads * hd, arch.num_kv_heads * hd
    linears = 2 * (2 * d * q_out + 2 * d * kv_out) + 6 * d * ffn  # per token, q / k / v / out and the SwiGLU
    gen_layer = gen_tokens * linears + 4 * gen_tokens * (und_tokens + gen_tokens) * q_out
    und_layer = und_tokens * linears + 4 * und_tokens * und_tokens * q_out
    trained = arch.num_layers * gen_layer + 2 * gen_tokens * d * arch.patch_latent_dim
    frozen = 2 * gen_tokens * arch.patch_latent_dim * d + 2 * gen_tokens * (256 * d + d * d) + \
        arch.num_layers * und_layer + 2 * und_tokens * d * arch.vocab_size
    return batch * trained, batch * frozen


def cosmos3_step_flops(arch, batch: int, gen_tokens: int, und_tokens: int) -> int:
    """Model FLOPs of one Cosmos3 train step (the adapted part x 3, the rest once)."""
    trained, frozen = cosmos3_flops(arch, batch, gen_tokens, und_tokens)
    return 3 * trained + frozen


def _cosmos3_avae(gen) -> dict:
    """The AVAE audio tokenizer at its shipped config
    (``Cosmos3AudioTokenizerConfig()``: 496M parameters, f32), its weights
    drawn on the card (lecun-normal convs, the residual units' closing 1 x 1
    convs at a tenth of that, SnakeBeta's log-scale alpha and beta N(0, 0.1):
    at full lecun scale the untrained decoder's residual stream grows to a
    std of tens and the clamp saturates nearly every sample): encode and decode of ``C3_AUDIO_SECONDS`` s of 48 kHz
    stereo (250 latent frames of 64) timed, then a ``C3_AUDIO_EXCERPT``-sample
    excerpt encoded and decoded on the card and by the same module in
    float64 on the CPU, within ``C3_AVAE_REL_L2``."""
    import torch

    from simpletuner_tpu_torch.models.cosmos3.audio_tokenizer import Cosmos3AudioTokenizer, Cosmos3AudioTokenizerConfig
    from simpletuner_tpu_torch.models.layers import init_parameters

    cfg = Cosmos3AudioTokenizerConfig()
    t0 = time.perf_counter()
    with torch.device("cuda"):
        tokenizer = init_parameters(Cosmos3AudioTokenizer(cfg), gen).eval()
    with torch.no_grad():
        for name, param in tokenizer.named_parameters():
            if name.endswith(("alpha", "beta")):
                param.normal_(0.0, 0.1, generator=gen)
            elif "_res_" in name and name.endswith("conv2.weight"):
                param.mul_(0.1)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    params = {name: sum(p.numel() for p in getattr(tokenizer, name).parameters()) for name in ("encoder", "decoder")}
    samples = C3_AUDIO_RATE * C3_AUDIO_SECONDS
    wave = 0.3 * torch.randn((1, cfg.audio_channels, samples), generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        tokenizer.decode(tokenizer.encode(wave[..., :C3_AUDIO_EXCERPT]))  # warm-up (cuDNN's algorithm choice)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        latents = tokenizer.encode(wave)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        audio = tokenizer.decode(latents)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    if tuple(latents.shape) != (1, cfg.vocoder_input_dim, samples // cfg.hop_size) or \
            tuple(audio.shape) != (1, cfg.dec_out_channels, samples) or not torch.isfinite(audio).all() or \
            float(audio.abs().max()) > 1.0:
        raise RuntimeError(f"cosmos3 AVAE: latents {tuple(latents.shape)}, audio {tuple(audio.shape)}")
    excerpt = wave[..., :C3_AUDIO_EXCERPT]
    with torch.no_grad():
        card_latents = tokenizer.encode(excerpt)
        card_audio = tokenizer.decode(card_latents)
    cpu = Cosmos3AudioTokenizer(cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in tokenizer.state_dict().items()})
    cpu = cpu.double()
    t3 = time.perf_counter()
    with torch.no_grad():
        ref_latents = cpu.encode(excerpt.cpu().double())
        ref_audio = cpu.decode(ref_latents)
    cpu_s = time.perf_counter() - t3
    errors = {"latents_rel_l2": rel_l2(card_latents.double().cpu(), ref_latents),
              "audio_rel_l2": rel_l2(card_audio.double().cpu(), ref_audio)}
    if not all(err <= C3_AVAE_REL_L2 for err in errors.values()):
        raise RuntimeError(f"cosmos3 AVAE on the card against float64: {errors} (<= {C3_AVAE_REL_L2})")
    encode_s, decode_s = t1 - t0, t2 - t1
    report = {"config": "Cosmos3AudioTokenizerConfig() (the shipped AVAE)", "params": params,
              "params_total": sum(params.values()), "build_s": build_s, "samples": samples,
              "rate": C3_AUDIO_RATE, "channels": cfg.audio_channels, "latents": list(latents.shape),
              "encode_s": encode_s, "decode_s": decode_s,
              "audio_s_per_s": {"encode": C3_AUDIO_SECONDS / encode_s, "decode": C3_AUDIO_SECONDS / decode_s,
                                "both": C3_AUDIO_SECONDS / (encode_s + decode_s)},
              "clamped_share": float((audio.abs() >= 1.0).float().mean()), "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "excerpt_samples": C3_AUDIO_EXCERPT, "float64_cpu_s": cpu_s, "bound": C3_AVAE_REL_L2, **errors}
    del tokenizer, cpu, wave, latents, audio
    return report


def cosmos3_phase(paths: dict, kernels, device: str, full_in_memory: bool, kernel_cases: dict) -> dict:
    """Phase 45: Cosmos3 at the JAX preset's full width (``Cosmos3Config()``):
    ``cosmos3_flops`` against the flop counter on two small configs; a
    seeded e4m3 checkpoint in the flat layout at ``C3_FILE_LAYERS`` of 36
    layers with the whole 151,936 x 4096 table and ``lm_head``, and a seeded
    word-level tokenizer in the model dir, so that ``encode_text`` reads it
    through ``AutoTokenizer`` (not the salted hash); 16 prompts encoded at 64
    ids (prompts/s); the import held bitwise, and the reasoner's parameters
    read from the same file and held bitwise to the MoT's understanding
    pathway; one forward against the plain attention on a 17-frame clip
    (4,400 generation tokens); the reasoner over the same 64 ids and the
    generator-only replay held to the full MoT forward; the true-CFG flow
    Euler loop over the 93-frame clip's latents (21,120 generation tokens)
    without a decode, the empty prompt's ids as the negative; 6 graphed
    rank-16 LoRA steps on the default targets (``attn_gen_q/k/v/out``) on an
    int8 base (``quantized_matmul`` full, every layer checkpointed) through
    ``build_train_step``, a replay bitwise against an eager step and a
    profiled replay's launches by shape; the AVAE audio tokenizer at its
    shipped config; in a run that names the phase, all 36 layers built in
    memory (15 GB of int8) and their graphed step timed.  Last, where phase
    46 does not run, the run's writes against the target.  Returns the launches per step of each
    kernel at the generation shape."""
    import gc

    import torch

    from simpletuner_tpu_torch.bench_cache import prompts_for
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import cosmos3_checkpoint_shapes
    from simpletuner_tpu_torch.models.cosmos3 import Cosmos3, Cosmos3Config, Cosmos3OmniTransformer
    from simpletuner_tpu_torch.models.cosmos3.reasoner import (
        Cosmos3Reasoner, Cosmos3ReasonerConfig, load_cosmos3_reasoner,
    )
    from simpletuner_tpu_torch.models.layers import init_adapters
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
    from simpletuner_tpu_torch.models.weight_import import cosmos3_params_from_checkpoint, load_transformer_params

    start = time.perf_counter()
    work = paths["work"]
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    tiny = Cosmos3Config.tiny()
    narrow = dataclasses.replace(tiny, vocab_size=50, hidden_size=48, head_dim=8, num_heads=4, num_kv_heads=2,
                                 num_layers=1, intermediate_size=40, latent_channel=3, rope_axes_dim=(2, 1, 1))
    cases = []
    for arch, grid, txt in ((tiny, (2, 4, 6), 6), (narrow, (3, 2, 4), 5)):
        family = Cosmos3(config_namespace({"model_family": "cosmos3", "model_arch_preset": "tiny"}), arch=arch)
        inputs = family.get_model_inputs({
            "noisy_latents": torch.zeros((2,) + grid + (arch.latent_channel,)), "timesteps": torch.full((2,), 0.5),
            "text_ids": torch.ones((2, txt), dtype=torch.int32)})
        cases.append((arch, tuple(inputs[k] for k in ("text_ids", "vision_tokens", "position_ids", "timesteps")),
                      (inputs["vision_tokens"].shape[1], txt)))
    flop_checks = _flop_checks(_x3(cosmos3_flops), Cosmos3OmniTransformer, cases)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(45)
    full = Cosmos3Config()
    if (full.vocab_size, full.hidden_size, full.head_dim, full.num_heads, full.num_kv_heads, full.num_layers,
            full.intermediate_size, full.latent_channel, full.patch_latent_dim, full.rope_theta,
            full.rope_axes_dim) != (151936, 4096, 128, 32, 8, 36, 12288, 48, 192, 5e6, (24, 20, 20)):
        raise RuntimeError(f"not the JAX preset of Cosmos3: {full}")
    if C3_GEN != 21120 or C3_KEYS != 21184:
        raise RuntimeError(f"cosmos3: {C3_LATENT} latents give {C3_GEN} generation tokens")
    arch = dataclasses.replace(full, num_layers=C3_FILE_LAYERS)
    shapes = cosmos3_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 6e9 or written_before + file_bytes / 1e9 + 0.05 + _reserved(45) > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"cosmos3: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the "
                           f"phase; it writes {file_bytes / 1e9 + 0.05:.1f} GB of the {RUN_WRITE_TARGET_GB} GB a "
                           "run may write")

    # (b) the seeded MoT (two e4m3 shards under transformer/) and a word-level
    # tokenizer at the model dir's root, where the family's AutoTokenizer reads it
    c3_dir = os.path.join(work, "cosmos3")
    weights, write_s = _write_e4m3_transformer(c3_dir, shapes, gen)
    prompts = [f"{TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]}, {p}" for i, p in enumerate(prompts_for(TEXT_PROMPTS))]
    write_gemma_tokenizer(c3_dir, " ".join(TRAIN_CAPTIONS + [C3_PROMPT] + prompts).split())
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "layers": [C3_FILE_LAYERS, full.num_layers],
             "table_and_head": [full.vocab_size, full.hidden_size], "written_gb_before": written_before,
             "written_gb_after": _written_gb(), "free_gb_before": free / 1e9}

    # (c) 16 prompts at 64 ids through the tokenizer
    values = {"model_family": "cosmos3", "model_type": "full", "mixed_precision": "bf16",
              "pretrained_model_name_or_path": c3_dir}
    family = Cosmos3(config_namespace(values))
    t0 = time.perf_counter()
    family._resolve_tokenizer()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    payloads = family.encode_text(prompts)
    encode_s = time.perf_counter() - t0
    ids = [p["text_ids"] for p in payloads]
    if family._tokenizer is None or any(x.shape != (C3_TEXT,) or int(x.max()) >= full.vocab_size for x in ids) or \
            family.encode_text(prompts[:1])[0]["text_ids"].tolist() != ids[0].tolist():
        raise RuntimeError(f"cosmos3 encode_text: tokenizer {family._tokenizer}, ids {[x.shape for x in ids]}")
    text = {"prompts": len(prompts), "ids": C3_TEXT, "tokenizer_load_s": load_s, "s": encode_s,
            "prompts_per_s": len(prompts) / encode_s,
            "tokenizer": type(family._tokenizer).__name__, "valid_ids": [int((x != 0).sum()) for x in ids[:4]]}
    batch = _text_batch(family, C3_PROMPT, (1,) + C3_LATENT + (48,), dev)
    negative = _text_batch(family, "", (1,) + C3_LATENT + (48,), dev)
    if tuple(batch["text_ids"].shape) != (1, C3_TEXT) or int((negative["text_ids"] != 0).sum()) != 1:
        raise RuntimeError(f"cosmos3: the collated ids {tuple(batch['text_ids'].shape)}, the empty prompt's "
                           f"{negative['text_ids'].tolist()} (its <bos> alone)")

    # (d) the import, bitwise; the reasoner from the same file
    model = ModelRegistry.create("cosmos3", config_namespace(values))
    if model.arch != arch:
        raise RuntimeError(f"cosmos3: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()
    imported = _import_bitwise(model, module, c3_dir, weights, cosmos3_params_from_checkpoint, file_bytes)
    params = sum(math.prod(v) for v in cosmos3_checkpoint_shapes(full).values())
    del weights
    rcfg = Cosmos3ReasonerConfig(num_layers=C3_FILE_LAYERS)
    if rcfg.as_transformer_config() != arch:
        raise RuntimeError(f"cosmos3: the reasoner's MoT config {rcfg.as_transformer_config()}")
    t0 = time.perf_counter()
    with torch.device(dev):
        reasoner = Cosmos3Reasoner(rcfg, torch.bfloat16)
    load_flax_params(reasoner, load_cosmos3_reasoner(rcfg, c3_dir)["params"])
    torch.cuda.synchronize()
    reasoner_s = time.perf_counter() - t0
    mot = module.state_dict()
    renames = {"to_q": "attn_und_q", "to_k": "attn_und_k", "to_v": "attn_und_v", "to_out": "attn_und_out",
               "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj", "down_proj": "mlp.down_proj"}
    unequal = []
    for name, tensor in reasoner.state_dict().items():
        parts = name.split(".")
        source = f"{parts[0]}.{renames[parts[1]]}.{parts[2]}" if len(parts) == 3 and parts[1] in renames else name
        if not torch.equal(tensor, mot[source]):
            unequal.append(name)
    if unequal:
        raise RuntimeError(f"cosmos3 reasoner: tensors unlike the MoT's understanding pathway: {unequal[:8]}")
    imported["reasoner"] = {"s": reasoner_s, "tensors_bitwise_the_mot": len(reasoner.state_dict()),
                            "params": sum(p.numel() for p in reasoner.parameters())}

    # (e) the parity forward on the 17-frame clip, (f) the replay identity
    gen_key, parity_key = f"32x{C3_GEN}x{C3_KEYS}x128", f"32x{math.prod(C3_PARITY_LATENT) // 4}x" \
                                                       f"{math.prod(C3_PARITY_LATENT) // 4 + C3_TEXT}x128"
    parity_batch = {**batch, "latents": torch.zeros((1,) + C3_PARITY_LATENT + (48,), device=dev)}
    launches = _forward_launches(model, module, parity_batch, kernels, C3_SIGMA)
    if launches["flash_fwd"] != {parity_key: C3_FILE_LAYERS}:
        raise RuntimeError(f"cosmos3 forward: launches by shape {launches}")
    noise = torch.randn((1,) + C3_PARITY_LATENT + (48,), generator=gen, device=dev)
    parity = {**_parity_forward(model, module, parity_batch, noise, C3_SIGMA), "frames": 17,
              "tokens": math.prod(C3_PARITY_LATENT) // 4, "launches_by_shape": launches}
    inputs = model.get_model_inputs({"noisy_latents": noise, "timesteps": torch.full((1,), C3_SIGMA, device=dev),
                                     "text_ids": batch["text_ids"]})
    with torch.no_grad():
        full_pred, logits = module(**inputs)
        memory = reasoner(inputs["text_ids"], inputs["position_ids"][:, :, :C3_TEXT])
        replayed, no_logits = module(None, inputs["vision_tokens"], inputs["position_ids"], inputs["timesteps"],
                                     reasoner_kv=memory)
        full_ms = cuda_ms(lambda: module(**inputs), 3, warmup=1)
        replay_ms = cuda_ms(lambda: module(None, inputs["vision_tokens"], inputs["position_ids"],
                                           inputs["timesteps"], reasoner_kv=memory), 3, warmup=1)
        reasoner_ms = cuda_ms(lambda: reasoner(inputs["text_ids"], inputs["position_ids"][:, :, :C3_TEXT]), 3)
    if no_logits is not None or not torch.isfinite(full_pred).all() or not torch.equal(replayed, full_pred) or \
            tuple(logits.shape) != (1, C3_TEXT, full.vocab_size) or not torch.isfinite(logits).all():
        raise RuntimeError(f"cosmos3 replay: max |replay - full| {float((replayed - full_pred).abs().max())}, "
                           f"logits {tuple(logits.shape)}")
    replay = {"tokens": math.prod(C3_PARITY_LATENT) // 4, "memory_layers": len(memory),
              "bitwise_equal_to_the_full_forward": True, "tolerance": "bitwise (0)", "full_forward_ms": full_ms,
              "replay_forward_ms": replay_ms, "reasoner_ms": reasoner_ms}
    del memory, full_pred, replayed, logits, inputs, reasoner

    # (g) the CFG sampler loop over the 93-frame clip's latents, no decode
    sampler = _cfg_sampler(model, module, batch, negative, kernels, C3_GUIDANCE, (1,) + C3_LATENT + (48,), gen,
                           {gen_key: C3_FILE_LAYERS})
    sampler["decode"] = "none: neither package has a video VAE for 48 latent channels (ROADMAP Queue 3)"
    del module, model, negative, parity_batch
    gc.collect()
    torch.cuda.empty_cache()

    # (h) 6 graphed rank-16 LoRA steps on the default targets, int8 base, through build_train_step
    train_values = {**_graph_train_values("cosmos3", C3_TRAIN_STEPS),
                    "lora_target_modules": list(Cosmos3.DEFAULT_LORA_TARGET)}
    train_model = Cosmos3(config_namespace(train_values))
    with torch.device(dev):
        train_module = load_transformer_params(train_model, init_adapters(train_model.create_module(), gen), c3_dir)
    adapted = sorted({name.rsplit(".", 1)[0].split(".", 1)[1] for name, _ in train_module.named_parameters()
                      if name.endswith("lora_A")})
    if adapted != sorted(f"attn_gen_{n}" for n in ("k", "out", "q", "v")):
        raise RuntimeError(f"cosmos3 train: adapters on {adapted}")
    train_batch = {"latents": torch.randn((1,) + C3_LATENT + (48,), generator=gen, device=dev),
                   "text_ids": batch["text_ids"]}
    step_keys = {gen_key: (C3_FILE_LAYERS, True)}
    train = _graph_vs_eager(train_model, train_module, train_batch, kernels, C3_TRAIN_STEPS,
                            _totals(_by_shape_per_step(step_keys)), cosmos3_step_flops(arch, 1, C3_GEN, C3_TEXT))
    by_shape = train["launches_per_step_by_shape"]
    if by_shape != _by_shape_per_step(step_keys):
        raise RuntimeError(f"cosmos3 train: launches per step by shape {by_shape}")
    train.update({"base": "int8", "quantized_matmul": "full", "remat": "every layer", "lora_rank": 16,
                  "lora_targets": list(Cosmos3.DEFAULT_LORA_TARGET), "flop_checks": flop_checks,
                  "causal_blocks": f"{C3_FILE_LAYERS} a forward (the understanding pathway, a plain f32 block "
                                   "without a gradient: phase 3's c3_und_block times it)"})
    del train_module, train_model
    gc.collect()
    torch.cuda.empty_cache()

    # (i) the AVAE audio tokenizer at its shipped config
    avae = _cosmos3_avae(gen)
    gc.collect()
    torch.cuda.empty_cache()

    # (j) in a run that names the phase: all 36 layers built in memory, graphed
    full_depth = None
    if full_in_memory:
        deep = Cosmos3(config_namespace(train_values), arch=full)
        deep_keys = {gen_key: (full.num_layers, True)}
        full_depth = _graph_vs_eager(deep, _drawn_in_memory(deep, gen), train_batch, kernels, C3_FULL_STEPS,
                                     _totals(_by_shape_per_step(deep_keys)),
                                     cosmos3_step_flops(full, 1, C3_GEN, C3_TEXT))
        if full_depth["launches_per_step_by_shape"] != _by_shape_per_step(deep_keys):
            raise RuntimeError(f"cosmos3 36 layers: launches per step by shape "
                               f"{full_depth['launches_per_step_by_shape']}")
        full_depth.update({"layers": [full.num_layers, full.num_layers], "base": "int8 (built in memory)",
                           "quantized_matmul": "full", "remat": "every layer", "lora_rank": 16})
        del deep
        gc.collect()
        torch.cuda.empty_cache()
    del batch, train_batch
    shutil.rmtree(c3_dir, ignore_errors=True)
    writes = {} if _runs(46) else check_run_writes()  # the last phase of this run
    phase("45 cosmos3", config="the Cosmos3 omni MoT as the JAX preset Cosmos3Config() builds it (nvidia Cosmos3 "
          "flat layout)", params=params, params_per_layer=sum(math.prod(v) for k, v in shapes.items()
                                                             if k.startswith("layers.0.")),
          hidden=full.hidden_size, heads=[full.num_heads, full.num_kv_heads, full.head_dim],
          depth={"file": [C3_FILE_LAYERS, full.num_layers], "train": [C3_FILE_LAYERS, full.num_layers],
                 "in_memory": [full.num_layers if full_in_memory else 0, full.num_layers]},
          clip=[93, 704, 1280], latents=list(C3_LATENT) + [48],
          tokens={"text": C3_TEXT, "generation": C3_GEN, "keys": C3_KEYS}, files=files, text=text,
          imported=imported, parity=parity, replay=replay, sampler=sampler, train=train, full_depth=full_depth,
          avae=avae, kernel_cases=kernel_cases, allocated_gib_before_phase=baseline_gib,
          seconds=time.perf_counter() - start, device=device, **writes)
    return {"c3_gen": {k: v.get(gen_key, 0) for k, v in by_shape.items()}}


def ltx2_flops(arch, batch: int, video_tokens: int, audio_tokens: int, text_tokens: int,
               tokenwise: bool = False) -> tuple:
    """Model FLOPs of one LTX-2 forward as (the adapted part, the rest): per
    block the six attentions' projections and two products each (video self;
    audio self; the two prompt cross-attentions, their keys and values over
    the text; a2v with its keys and values over the audio, v2a with its over
    the video) and the two FFNs; the projections in and out of both streams
    and the caption MLPs (all carry adapters); then the six adaLN heads,
    whose inputs carry no gradient: ``time_embed`` over every video token
    when the timesteps are tokenwise, the others once a sample.  Gated
    attention is not counted (the published config has none)."""
    d, a, sv, sa, lt = arch.inner_dim, arch.audio_inner_dim, video_tokens, audio_tokens, text_tokens
    ai = arch.audio_num_heads * arch.audio_head_dim
    block = (8 * sv * d * d + 4 * sv * sv * d + 8 * sa * a * ai + 4 * sa * sa * ai
             + 4 * sv * d * d + 4 * lt * d * d + 4 * sv * lt * d + 4 * sa * a * ai + 4 * lt * a * ai + 4 * sa * lt * ai
             + 4 * sv * d * ai + 4 * sa * a * ai + 4 * sv * sa * ai + 4 * sa * a * ai + 4 * sv * d * ai
             + 4 * sa * sv * ai + 16 * sv * d * d + 16 * sa * a * a)
    trained = (arch.num_layers * block + 4 * sv * arch.in_channels * d + 4 * sa * arch.audio_in_channels * a
               + 2 * lt * arch.caption_channels * (d + a) + 2 * lt * (d * d + a * a))
    rows = sv if tokenwise else 1
    frozen = (2 * rows * (256 * d + d * d + 6 * d * d) + 2 * (256 * a + a * a + 6 * a * a)
              + 2 * (256 * d + d * d + 4 * d * d) + 2 * (256 * d + 2 * d * d)
              + 2 * (256 * a + a * a + 4 * a * a) + 2 * (256 * a + 2 * a * a))
    return batch * trained, batch * frozen


def ltx2_step_flops(arch, batch: int, video_tokens: int, audio_tokens: int, text_tokens: int,
                    tokenwise: bool = False) -> int:
    """Model FLOPs of one LTX-2 train step (the adapted part x 3, the rest once)."""
    trained, frozen = ltx2_flops(arch, batch, video_tokens, audio_tokens, text_tokens, tokenwise)
    return 3 * trained + frozen


def _ltx2_keys(video: int, audio: int) -> tuple:
    """The "HxSqxSkxD" keys of an LTX-2 block's six attentions over ``video``
    and ``audio`` tokens: video self, video prompt cross, a2v, v2a, audio
    self, audio prompt cross."""
    return (f"32x{video}x{video}x128", f"32x{video}x{L2_TEXT}x128", f"32x{video}x{audio}x64",
            f"32x{audio}x{video}x64", f"32x{audio}x{audio}x64", f"32x{audio}x{L2_TEXT}x64")


def _ltx2_launches(video: int, audio: int, blocks: int, audio_loss: bool) -> dict:
    """The launches per step by shape of an LTX-2 step that checkpoints
    every block: each attention's forward twice a block (the forward and its
    recompute) and its dq / dkv once, except the last block's v2a without an
    audio loss (its output reaches only the audio prediction, which then
    reaches no loss, so no gradient runs through it)."""
    keys = _ltx2_keys(video, audio)
    grads = {key: blocks - (key == keys[3] and not audio_loss) for key in keys}
    return {"flash_fwd": {key: 2 * blocks for key in keys},
            **{kernel: {k: n for k, n in grads.items() if n} for kernel in ("flash_bwd_dq", "flash_bwd_dkv")}}


def ltx2_phase(paths: dict, kernels, device: str, full_in_memory: bool, kernel_cases: dict) -> dict:
    """Phase 46: LTX-2 at the JAX preset's full width (``LTX2Config()``):
    ``ltx2_flops`` against the flop counter on two small configs (one
    tokenwise); a seeded e4m3 diffusers transformer at ``LTX2_FILE_BLOCKS`` of
    48 blocks with every parameter outside them, a seeded e4m3 latent
    upsampler at ``LTX2UpsamplerConfig()`` with its config in the file's
    metadata, hard links to phase 43's Gemma-2 and tokenizer (written here in
    a run without them) and phase 24's two seeded 768 x 512 x 121 clips
    linked (written here in a run without phase 24); the import held
    bitwise; ``Trainer.run()``: the text cache at 256 tokens, the video VAE
    cache at the family's ``video_vae_config()``, 6 graphed rank-16 LoRA
    steps on a bf16 base (every adapter-carrying linear, all six attentions
    of a block) with every block checkpointed and the first frame held clean
    (``ltx2_first_frame_conditioning_probability`` 1: every DiT call takes
    tokenwise (1, 6144) timesteps, recorded), a replay bitwise against an
    eager step and the profiled replay held to the capture's launches by
    shape (the JAX data plane gives no audio latents: one zero audio token,
    and the last block's v2a takes no gradient);
    the joint audiovisual step: 6 graphed steps through ``build_train_step``
    on an int8 base (``quantized_matmul`` full) on a batch with 121 seeded
    audio latent tokens and the caption mask, a replay against eager steps,
    ``audio_loss``; the trained-stage true-CFG render and the spatial-upscale
    render through the upsampler file, both at 768 px square and 25 frames,
    decoded, written as mp4 and read back; one forward against the plain
    attention on 25 frames (1,536 video and 25 audio tokens); one forward of
    the Gemma connectors at their published config built in memory (1.43B
    parameters, bf16) on left-padded stacked features with 180 valid tokens,
    against the plain attention; in a run that names the phase, all 48 blocks
    built in memory on an int8 base and their graphed joint step timed.
    Last, the run's writes against the target.  Returns the launches per
    step of each kernel at the joint step's six shapes and the connectors'."""
    import gc

    import torch

    from simpletuner_tpu_torch.inference import CheckpointInferenceRuntime, config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import (
        ltx2_checkpoint_shapes, ltx2_connector_checkpoint_shapes, ltx2_upsampler_checkpoint_shapes,
    )
    from simpletuner_tpu_torch.models.layers import init_adapters, init_parameters
    from simpletuner_tpu_torch.models.ltxvideo2 import LTX2Config, LTX2Transformer, LTXVideo2
    from simpletuner_tpu_torch.models.ltxvideo2.connectors import LTX2ConnectorConfig, LTX2TextConnectors
    from simpletuner_tpu_torch.models.ltxvideo2.latent_upsampler import LTX2UpsamplerConfig
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.video_vae import VideoAutoencoderKL
    from simpletuner_tpu_torch.models.weight_import import (
        load_transformer_params, ltx2_params_from_diffusers, save_safetensors,
    )
    from simpletuner_tpu_torch.ops import set_attention_backend

    start = time.perf_counter()
    work = paths["work"]
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(46)

    # (a) the flop count against the counter on two small configs, the first tokenwise
    tiny = LTX2Config.tiny()
    narrow = dataclasses.replace(tiny, num_heads=3, head_dim=8, audio_num_heads=2, audio_head_dim=4,
                                 audio_cross_attention_dim=8, num_layers=1, caption_channels=12)
    cases = []
    for arch_, (f, h, w), sa, txt, tokenwise in ((tiny, (2, 4, 6), 5, 7, True), (narrow, (3, 2, 4), 3, 5, False)):
        sv = f * h * w
        t = torch.rand((2, sv), generator=torch.Generator().manual_seed(sv)) if tokenwise else torch.full((2,), 0.5)
        cases.append((arch_, (torch.zeros(2, sv, arch_.in_channels), torch.zeros(2, sa, arch_.audio_in_channels),
                              torch.zeros(2, txt, arch_.caption_channels), t, f, h, w), (sv, sa, txt, tokenwise)))
    flop_checks = _flop_checks(_x3(ltx2_flops), LTX2Transformer, cases)
    full = LTX2Config()
    if (full.inner_dim, full.num_heads, full.head_dim, full.audio_inner_dim, full.audio_num_heads,
            full.audio_head_dim, full.num_layers, full.in_channels, full.audio_in_channels,
            full.caption_channels, full.gated_attn, full.audio_gated_attn) != \
            (4096, 32, 128, 2048, 32, 64, 48, 128, 128, 3840, False, False):
        raise RuntimeError(f"not the JAX preset of LTX-2: {full}")
    if L2_TOKENS != 6144:
        raise RuntimeError(f"ltxvideo2: {L2_LATENT} latents give {L2_TOKENS} video tokens")
    arch = dataclasses.replace(full, num_layers=LTX2_FILE_BLOCKS)
    depth = arch.num_layers
    shapes, up_cfg = ltx2_checkpoint_shapes(arch), LTX2UpsamplerConfig()
    up_shapes = ltx2_upsampler_checkpoint_shapes(up_cfg)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    up_bytes = sum(math.prod(shape) for shape in up_shapes.values())
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + up_bytes + 8e9 or \
            written_before + PHASE46_WRITE_GB + _reserved(46) > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"ltxvideo2: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the "
                           f"phase; it writes {PHASE46_WRITE_GB:.2f} GB of the {RUN_WRITE_TARGET_GB} GB a run may "
                           "write")

    # (b) the seeded transformer (two e4m3 shards), the upsampler, Gemma-2 linked (or written), two clips
    root = os.path.join(work, "ltxvideo2")
    weights, write_s = _write_e4m3_transformer(root, shapes, gen)
    up_path = os.path.join(work, "ltx2_spatial_upscaler.safetensors")
    up_weights = {k: v.to(torch.float8_e4m3fn) for k, v in seeded_weights(up_shapes, gen).items()}
    t0 = time.perf_counter()
    save_safetensors(up_weights, up_path, metadata={"config": json.dumps({"dims": 3, **dataclasses.asdict(up_cfg)})})
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "blocks": [depth, full.num_layers],
             "outside_blocks": sum(math.prod(v) for k, v in shapes.items() if not k.startswith("transformer_blocks.")),
             "upsampler": {"gb": up_bytes / 1e9, "params": up_bytes, "write_s": time.perf_counter() - t0,
                           "config": dataclasses.asdict(up_cfg)}}
    gemma = paths.get("gemma_root")
    if gemma and os.path.isdir(os.path.join(gemma, "text_encoder")):
        for sub in ("text_encoder", "tokenizer"):
            _link_tree(os.path.join(gemma, sub), os.path.join(root, sub))
        files["gemma2"] = {"linked_from_phase": 43, "layers": [GEMMA_FILE_LAYERS, 26]}
    else:
        files["gemma2"] = {"written_by_phase": 46, "layers": [GEMMA_FILE_LAYERS, 26], "write_s":
                           write_gemma_trunk(os.path.join(root, "text_encoder"), GEMMA_FILE_LAYERS, gen)}
        write_gemma_tokenizer(os.path.join(root, "tokenizer"), " ".join(TRAIN_CAPTIONS + [L2_PROMPT]).split())
    data, cache = os.path.join(work, "ltxvideo2_data"), os.path.join(work, "ltxvideo2_cache")
    clips = paths.get("ltx_clips")
    if clips and os.path.isdir(clips) and (L2_CLIPS, L2_FRAMES, L2_HEIGHT, L2_WIDTH) == \
            (LTX_CLIPS, LTX_FRAMES, LTX_HEIGHT, LTX_WIDTH):
        _link_tree(clips, data)
        files["clips"] = {"linked_from_phase": 24, "clips": L2_CLIPS}
    else:
        files.update(_write_clips(data, L2_CLIPS, L2_FRAMES, L2_HEIGHT, L2_WIDTH, 25, 46))
    files.update({"written_gb_before": written_before, "written_gb_after": _written_gb(), "free_gb_before": free / 1e9})

    # (c) the import, bitwise
    model = ModelRegistry.create("ltxvideo2", config_namespace({"model_family": "ltxvideo2", "model_type": "full"}))
    if model.arch != arch:
        raise RuntimeError(f"ltxvideo2: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()
    imported = _import_bitwise(model, module, root, weights, ltx2_params_from_diffusers, file_bytes)
    params = sum(math.prod(v) for v in ltx2_checkpoint_shapes(full).values())
    del weights, module, model
    gc.collect()
    torch.cuda.empty_cache()

    # (d) Trainer.run() on the clips: bf16 base, every block checkpointed, the first frame clean
    out = os.path.join(work, "ltxvideo2_train")
    config = _video_config("ltxvideo2", root, data, cache, out, L2_FRAMES, L2_TRAIN_STEPS, alignment=32,
                           ltx2_first_frame_conditioning_probability=1.0)
    # no JAX data path gives audio latents: one zero audio token, and no audio loss
    train_launches = _ltx2_launches(L2_TOKENS, 1, depth, audio_loss=False)
    timestep_shapes = []  # the DiT's timesteps at each eager call (the warm-up steps, the capture, the eager check)
    forward = LTX2Transformer.forward

    def recording(self, *args, **kwargs):
        timestep_shapes.append(tuple((kwargs["timesteps"] if "timesteps" in kwargs else args[3]).shape))
        return forward(self, *args, **kwargs)

    def check(trainer) -> dict:
        import numpy as np

        bundle = trainer.data_plane.bundles["clips"]
        buckets = sorted(bundle.metadata_backend.aspect_ratio_bucket_indices)
        clip_paths = [p for key in buckets for p in bundle.metadata_backend.aspect_ratio_bucket_indices[key]]
        cached = [bundle.vae_cache.load(p) for p in clip_paths]
        batch = trainer._example_batch()
        text = {k: tuple(v.shape) for k, v in batch.items() if k.startswith("text")}
        if trainer.model.arch != arch or len(clip_paths) != L2_CLIPS or \
                not isinstance(trainer.vae, VideoAutoencoderKL) or \
                trainer.vae.config != trainer.model.video_vae_config() or \
                any(c.shape != L2_LATENT + (128,) or not np.isfinite(c).all() for c in cached) or \
                text != {"text_embeds": (1, L2_TEXT, full.caption_channels)} or \
                set(timestep_shapes) != {(1, L2_TOKENS)}:
            raise RuntimeError(f"ltxvideo2 trainer: arch {trainer.model.arch}, buckets {buckets}, VAE "
                               f"{trainer.vae.config}, cached {[c.shape for c in cached]}, batch {text}, the DiT's "
                               f"timesteps {sorted(set(timestep_shapes))}")
        startup = trainer.data_plane.startup_metrics
        return {"buckets": buckets, "latents": list(cached[0].shape), "vae": "the family's video_vae_config() "
                "(128 latent channels, 32x spatial, 8x temporal)",
                "cache": {"text_s": startup.get("text_cache_clips_s"), "vae_s": startup.get("vae_cache_clips_s")},
                **_graph_matches_eager(trainer, ("loss", "grad_norm")),
                "dit_timesteps": sorted(set(timestep_shapes)), "dit_calls": len(timestep_shapes)}

    LTX2Transformer.forward = recording
    try:
        train = _train_graphed(config, kernels, L2_TRAIN_STEPS, _totals(train_launches),
                               ltx2_step_flops(arch, 1, L2_TOKENS, 1, L2_TEXT, tokenwise=True), check)
    finally:
        LTX2Transformer.forward = forward
    if train["launches_per_step_by_shape"] != train_launches:
        raise RuntimeError(f"ltxvideo2 trainer: launches per step by shape {train['launches_per_step_by_shape']}")
    train.update({"base": "bf16", "remat": "every block", "lora_rank": 16, "audio_tokens": 1,
                  "lora_targets": "every adapter-carrying linear (no code reads DEFAULT_LORA_TARGET): the six "
                                  "attentions, the FFNs, the projections and caption MLPs", "flop_checks": flop_checks})
    shutil.rmtree(out, ignore_errors=True)

    # (e) the joint audiovisual step through build_train_step on an int8 base, the caption mask riding
    joint_values = {**_graph_train_values("ltxvideo2", L2_TRAIN_STEPS), "ltx2_first_frame_conditioning_probability": 1.0}
    joint_model = LTXVideo2(config_namespace(joint_values))
    with torch.device(dev):
        joint_module = load_transformer_params(joint_model, init_adapters(joint_model.create_module(), gen), root)
    joint_batch = {"latents": torch.randn((1,) + L2_LATENT + (128,), generator=gen, device=dev),
                   "audio_latents": torch.randn((1, L2_AUDIO, 128), generator=gen, device=dev),
                   "text_embeds": torch.randn((1, L2_TEXT, full.caption_channels), generator=gen, device=dev),
                   "text_attention_mask": (torch.arange(L2_TEXT, device=dev) < L2_VALID)[None].to(torch.int32)}
    joint_launches = _ltx2_launches(L2_TOKENS, L2_AUDIO, depth, audio_loss=True)
    joint = _graph_vs_eager(joint_model, joint_module, joint_batch, kernels, L2_TRAIN_STEPS, _totals(joint_launches),
                            ltx2_step_flops(arch, 1, L2_TOKENS, L2_AUDIO, L2_TEXT, tokenwise=True),
                            metric_keys=("audio_loss",))
    by_shape = joint["launches_per_step_by_shape"]
    if by_shape != joint_launches or not 0 < joint["audio_loss"] < float("inf"):
        raise RuntimeError(f"ltxvideo2 joint step: launches per step by shape {by_shape}, audio_loss "
                           f"{joint['audio_loss']}")
    joint.update({"base": "int8", "quantized_matmul": "full", "remat": "every block", "lora_rank": 16,
                  "audio_tokens": L2_AUDIO, "caption_valid": L2_VALID})
    del joint_module, joint_model
    gc.collect()
    torch.cuda.empty_cache()

    # (f) the trained-stage true-CFG render, then the spatial-upscale render through the upsampler file
    render, runtime = _video_render(work, "ltxvideo2", root, "ltxvideo2", kernels, L2_PROMPT, L2_GUIDANCE,
                                    L2_RENDER_SIZE, L2_RENDER_FRAMES, 6 * depth)
    render["tokens"] = ((L2_RENDER_FRAMES - 1) // 8 + 1) * (L2_RENDER_SIZE // 32) ** 2
    module, model = runtime.module, runtime.model
    if model.arch != arch or model.NAME != "ltxvideo2":
        raise RuntimeError(f"ltxvideo2: the runtime built {model.NAME} {model.arch}")
    for target in {id(runtime.config): runtime.config, id(model.config): model.config}.values():
        target.ltx2_validation_pipeline_mode = "spatial-upscale"
        target.ltx2_validation_spatial_upsampler_model = up_path
    timed = _timed_render(runtime, kernels, L2_PROMPT, 1.0)
    upsampler = model._latent_upsampler
    stage_forwards = STEPS + len(LTXVideo2.LTX2_STAGE2_SIGMAS)
    rendered = timed["rendered"]
    read = _mp4_frame_shapes(rendered[0]) if rendered and rendered[0].endswith(".mp4") else []
    if upsampler is None or upsampler.config != up_cfg or \
            not torch.equal(upsampler.initial_conv.weight, up_weights["initial_conv.weight"].to(torch.float32)) or \
            timed["launches"] != {"flash_fwd": 6 * depth * stage_forwards, "flash_bwd_dq": 0, "flash_bwd_dkv": 0} or \
            len(timed["forward_s"]) != stage_forwards or timed["finite"] != [True] or \
            len(read) != L2_RENDER_FRAMES or set(read) != {(L2_RENDER_SIZE, L2_RENDER_SIZE, 3)}:
        raise RuntimeError(f"ltxvideo2 spatial-upscale render: upsampler {upsampler and upsampler.config}, "
                           f"launches {timed['launches']}, {len(timed['forward_s'])} forwards, finite "
                           f"{timed['finite']}, the mp4 holds {len(read)} frames of {set(read)}")
    upscale = {"render_s": timed["render_s"], "forward_s": timed["forward_s"], "steps": [STEPS, 3],
               "stage_tokens": [((L2_RENDER_FRAMES - 1) // 8 + 1) * (L2_RENDER_SIZE // 64) ** 2, render["tokens"]],
               "stage2_sigmas": list(LTXVideo2.LTX2_STAGE2_SIGMAS), "vae_decode_s": timed["decode_s"][0],
               "peak_gib": timed["peak_gib"], "launches": timed["launches"],
               "launches_by_shape": timed["launches_by_shape"], "mp4": os.path.basename(rendered[0]),
               "mp4_frames": len(read), "upsampler_params": sum(p.numel() for p in upsampler.parameters()),
               "upsampler_from": "the seeded e4m3 file, its config from the metadata, held bitwise"}
    for target in {id(runtime.config): runtime.config, id(model.config): model.config}.values():
        target.ltx2_validation_pipeline_mode = "trained-stage"

    # (g) 16 prompts through Gemma-2 and the tile to 3840; the parity forward on 25
    # frames with 25 audio tokens and the prompt's mask
    from simpletuner_tpu_torch.bench_cache import prompts_for

    prompts = [f"{TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]}, {p}" for i, p in enumerate(prompts_for(TEXT_PROMPTS))]
    t0 = time.perf_counter()
    payloads = model.encode_text(prompts)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    if any(p["text_embeds"].shape != (L2_TEXT, full.caption_channels) for p in payloads):
        raise RuntimeError(f"ltxvideo2 encode_text: {[p['text_embeds'].shape for p in payloads]}")
    text = {"prompts": len(prompts), "tokens": L2_TEXT, "s": encode_s, "prompts_per_s": len(prompts) / encode_s,
            "gemma2_width_tiled_to": full.caption_channels}
    (payload,) = model.encode_text([L2_PROMPT])
    caption_valid = int(payload["attention_mask"].sum())
    parity_latent = ((L2_PARITY_FRAMES - 1) // 8 + 1, L2_LATENT[1], L2_LATENT[2])
    tokens = math.prod(parity_latent)
    model.text_encoders = []  # the plain attention's scores need the room
    gc.collect()
    torch.cuda.empty_cache()
    inputs = {"video_tokens": torch.randn((1, tokens, 128), generator=gen, device=dev),
              "audio_tokens": torch.randn((1, L2_PARITY_AUDIO, 128), generator=gen, device=dev),
              "text_embeds": torch.as_tensor(payload["text_embeds"], device=dev)[None],
              "timesteps": torch.full((1,), L2_SIGMA, device=dev), "num_frames": parity_latent[0],
              "height": parity_latent[1], "width": parity_latent[2],
              "text_mask": torch.as_tensor(payload["attention_mask"], device=dev)[None]}
    for kernel in kernels:
        kernel.launches = 0
        kernel.shape_launches.clear()
    with torch.no_grad():
        kernel_out = module(**inputs)
        launches = _per_shape(kernels)
        set_attention_backend("xla")
        try:
            plain_out = module(**inputs)
        finally:
            set_attention_backend("auto")
        forward_ms = cuda_ms(lambda: module(**inputs), 3, warmup=1)
    parity_rel = [rel_l2(a, b) for a, b in zip(kernel_out, plain_out)]
    if launches["flash_fwd"] != {k: depth for k in _ltx2_keys(tokens, L2_PARITY_AUDIO)} or \
            not all(torch.isfinite(x).all() for x in kernel_out + plain_out) or max(parity_rel) > PARITY_REL_L2 or \
            not 1 < caption_valid < L2_TEXT:
        raise RuntimeError(f"ltxvideo2 parity: rel L2 (video, audio) {parity_rel} (<= {PARITY_REL_L2}), launches "
                           f"{launches}, caption {caption_valid} valid of {L2_TEXT}")
    parity = {"rel_l2": {"video": parity_rel[0], "audio": parity_rel[1]}, "bound": PARITY_REL_L2,
              "sigma": L2_SIGMA, "forward_ms": forward_ms, "frames": L2_PARITY_FRAMES,
              "tokens": {"video": tokens, "audio": L2_PARITY_AUDIO, "text": L2_TEXT, "text_valid": caption_valid},
              "launches_by_shape": launches}
    del runtime, module, model, inputs, kernel_out, plain_out, upsampler
    gc.collect()
    torch.cuda.empty_cache()

    # (h) the Gemma connectors at their published config, built in memory, left-padded features
    ccfg = LTX2ConnectorConfig()
    with torch.device(dev):
        connectors = init_parameters(LTX2TextConnectors(ccfg, torch.bfloat16), gen)
    connector_params = sum(p.numel() for p in connectors.parameters())
    if connector_params != sum(math.prod(v) for v in ltx2_connector_checkpoint_shapes(ccfg).values()):
        raise RuntimeError(f"ltxvideo2 connectors: {connector_params} parameters against the layout's")
    stacked = torch.randn((1, L2_TEXT, ccfg.caption_channels * ccfg.text_proj_in_factor), generator=gen, device=dev)
    mask = (torch.arange(L2_TEXT, device=dev) >= L2_TEXT - L2_VALID)[None].to(torch.int32)
    for kernel in kernels:
        kernel.launches = 0
        kernel.shape_launches.clear()
    with torch.no_grad():
        video_c, audio_c = connectors(stacked, mask)
        connector_launches = _per_shape(kernels)
        set_attention_backend("xla")
        try:
            plain_c = connectors(stacked, mask)
        finally:
            set_attention_backend("auto")
        connector_ms = cuda_ms(lambda: connectors(stacked, mask), 3, warmup=1)
    connector_rel = [rel_l2(a, b) for a, b in zip((video_c, audio_c), plain_c)]
    connector_key = f"{ccfg.num_heads}x{L2_TEXT}x{L2_TEXT}x{ccfg.head_dim}"
    if connector_launches["flash_fwd"] != {connector_key: 2 * ccfg.num_layers} or max(connector_rel) > PARITY_REL_L2 \
            or tuple(video_c.shape) != (1, L2_TEXT, ccfg.inner_dim) or not torch.isfinite(video_c).all():
        raise RuntimeError(f"ltxvideo2 connectors: rel L2 {connector_rel}, launches {connector_launches}, "
                           f"out {tuple(video_c.shape)}")
    connector = {"params": connector_params, "dtype": "bfloat16", "tokens": L2_TEXT, "valid": L2_VALID,
                 "stacked_width": ccfg.caption_channels * ccfg.text_proj_in_factor, "forward_ms": connector_ms,
                 "rel_l2_against_plain": {"video": connector_rel[0], "audio": connector_rel[1]},
                 "bound": PARITY_REL_L2, "launches_by_shape": connector_launches}
    del connectors, stacked, video_c, audio_c, plain_c
    gc.collect()
    torch.cuda.empty_cache()

    # (i) in a run that names the phase: all 48 blocks built in memory, int8, the joint step graphed
    full_depth = None
    if full_in_memory:
        deep = LTXVideo2(config_namespace(joint_values), arch=full)
        deep_launches = _ltx2_launches(L2_TOKENS, L2_AUDIO, full.num_layers, audio_loss=True)
        full_depth = _graph_vs_eager(deep, _drawn_in_memory(deep, gen), joint_batch, kernels, L2_FULL_STEPS,
                                     _totals(deep_launches),
                                     ltx2_step_flops(full, 1, L2_TOKENS, L2_AUDIO, L2_TEXT, tokenwise=True),
                                     metric_keys=("audio_loss",))
        if full_depth["launches_per_step_by_shape"] != deep_launches:
            raise RuntimeError(f"ltxvideo2 48 blocks: launches per step by shape "
                               f"{full_depth['launches_per_step_by_shape']}")
        full_depth.update({"blocks": [full.num_layers] * 2, "base": "int8 (built in memory)",
                           "quantized_matmul": "full", "remat": "every block", "lora_rank": 16,
                           "audio_tokens": L2_AUDIO})
        del deep
        gc.collect()
        torch.cuda.empty_cache()
    del joint_batch, up_weights
    for name in ("ltxvideo2", "ltxvideo2_data", "ltxvideo2_cache", "ltxvideo2_render", "ltx2_spatial_upscaler.safetensors",
                 "sana", "ltx_data"):
        target = os.path.join(work, name)
        if os.path.isdir(target):
            shutil.rmtree(target, ignore_errors=True)
        elif os.path.exists(target):
            os.remove(target)
    writes = check_run_writes()  # the last phase
    phase("46 ltxvideo2", config="Lightricks/LTX-2 transformer/ as the JAX preset LTX2Config() builds it",
          params=params, params_per_block=sum(math.prod(v) for k, v in shapes.items()
                                              if k.startswith("transformer_blocks.0.")),
          hidden={"video": full.inner_dim, "audio": full.audio_inner_dim},
          heads={"video": [full.num_heads, full.head_dim], "audio": [full.audio_num_heads, full.audio_head_dim]},
          depth={"file": [depth, full.num_layers], "train": [depth, full.num_layers],
                 "in_memory": [full.num_layers if full_in_memory else 0, full.num_layers]},
          clip=[L2_FRAMES, L2_HEIGHT, L2_WIDTH], latents=list(L2_LATENT) + [128],
          tokens={"video": L2_TOKENS, "audio": L2_AUDIO, "text": L2_TEXT}, files=files, imported=imported,
          text=text, train=train, joint=joint, render=render, upscale_render=upscale, parity=parity,
          connectors=connector,
          full_depth=full_depth, kernel_cases=kernel_cases, allocated_gib_before_phase=baseline_gib,
          seconds=time.perf_counter() - start, device=device, **writes)
    out = {case[0]: {k: v.get(key, 0) for k, v in by_shape.items()}
           for case, key in zip(LTX2_KERNEL_CASES, _ltx2_keys(L2_TOKENS, L2_AUDIO))}
    out["l2_connector"] = {k: v.get(connector_key, 0) for k, v in connector_launches.items()}
    return out


def acestep_flops(arch, batch: int, tokens: int, text_tokens: int, lyric_tokens: int) -> tuple:
    """Model FLOPs of one ACE-Step forward, counted from the config, as (the
    part the backward runs through, the rest): per block the Lite-LA q, k, v
    and out over the latent tokens and its two f32 products (V padded with
    the ones column), the cross-attention's q and out per latent token and k
    and v per conditioning token (1 + text + lyric), its two products, and
    GLUMBConv's 1 x 1 expansion, depthwise k = 3 conv and point conv; the
    final projection; then the patch embed's two convs, the timestep MLP and
    ``t_block`` (per sample), the speaker, caption and lyric projections and
    the conformer (the linear embed, per layer q, k, v, out and the FFN over
    the lyric tokens, ``linear_pos`` over the 2L - 1 relative positions once,
    and the content, position and value products), which carry no adapter
    and take no gradient input."""
    d, heads, hd = arch.inner_dim, arch.num_heads, arch.head_dim
    hidden, channels = int(d * arch.mlp_ratio), arch.in_channels
    patch, context = channels * arch.patch_mult, 1 + text_tokens + lyric_tokens
    ly, dl, ffn = lyric_tokens, arch.lyric_hidden, arch.lyric_ffn
    block = (8 * tokens * d * d + 4 * tokens * heads * (hd + 1) * hd + 4 * tokens * d * d + 4 * context * d * d
             + 4 * tokens * context * d + 4 * tokens * d * hidden + 12 * tokens * hidden + 2 * tokens * hidden * d)
    trained = batch * (arch.num_layers * block + 2 * tokens * d * arch.latent_height * channels)
    conformer = 2 * ly * dl * dl + arch.lyric_depth * (
        8 * ly * dl * dl + 2 * ly * ly * dl + 2 * ly * (2 * ly - 1) * dl + 2 * ly * ly * dl + 4 * ly * dl * ffn)
    frozen = batch * (2 * tokens * patch * channels * arch.latent_height + 2 * tokens * patch * d
                      + 2 * (256 * d + d * d) + 12 * d * d + 2 * arch.speaker_dim * d
                      + 2 * text_tokens * arch.text_dim * d + 2 * ly * dl * d + conformer)
    return trained, frozen + arch.lyric_depth * 2 * (2 * ly - 1) * dl * dl


def acestep_step_flops(arch, batch: int, tokens: int, text_tokens: int, lyric_tokens: int) -> int:
    """Model FLOPs of one ACE-Step train step (the adapted part x 3, the rest once)."""
    trained, frozen = acestep_flops(arch, batch, tokens, text_tokens, lyric_tokens)
    return 3 * trained + frozen


def write_lyrics_vocab(path: str, first_id: int = 270) -> None:
    """A seeded BPE lyric tokenizer in the ``tokenizers`` JSON format, as
    ACE-Step's ``lyrics_utils/vocab.json`` is: single characters and a few
    merges from ``first_id`` on (placeholders below it), the language tags
    and ``[SPACE]`` as special tokens."""
    from tokenizers import Tokenizer, models

    chars = list("abcdefghijklmnopqrstuvwxyz0123456789'.,!?-()[]")
    merges = [("t", "h"), ("th", "e"), ("i", "n"), ("in", "g"), ("e", "r"), ("o", "n"), ("a", "n")]
    vocab = {f"<unused{i}>": i for i in range(first_id)}  # ids below first_id: never produced
    for piece in chars + [a + b for a, b in merges]:
        vocab[piece] = len(vocab)
    tokenizer = Tokenizer(models.BPE(vocab=vocab, merges=merges))
    tokenizer.add_special_tokens(["[SPACE]", "[en]", "[zh]", "[ja]", "[ko]"])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tokenizer.save(path)


def _write_wav(path: str, seconds: float, rate: int, channels: int, seed: int) -> None:
    """A seeded 16-bit WAV: a chord of seeded tones with a little noise."""
    import numpy as np
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate), dtype=np.float64) / rate
    tones = sum(np.sin(2 * np.pi * f * t + p) for f, p in zip(rng.uniform(110, 880, 3), rng.uniform(0, 6, 3)))
    wave = 0.2 * tones[:, None] + 0.02 * rng.standard_normal((t.size, channels))
    wavfile.write(path, rate, (np.clip(wave, -1, 1) * 32767).astype(np.int16))


def ace_step_phase(paths: dict, kernels, device: str, full_in_memory: bool, kernel_cases: dict) -> dict:
    """Phase 47: ACE-Step at the JAX preset's full width (``ACEStepConfig()``):
    ``acestep_flops`` against the flop counter on two small configs; a seeded
    e4m3 diffusers-layout transformer at ``ACE_FILE_BLOCKS`` of 28 blocks with
    the conformer and conditioning whole, a seeded umT5 at umT5-base's 768
    width (``UMT5_LAYERS`` of 12 layers, bf16) beside phase 15's T5 tokenizer
    (``tokenizer_2``), a seeded BPE ``lyrics_utils/vocab.json``, and four
    seeded stereo 44.1 kHz 16-bit WAVs of 47 s with captions and
    ``.lyrics.txt`` sidecars; the import held bitwise; ``Trainer.run()``: audio
    discovery into the ``47s`` bucket, the text cache at 256 tokens, the audio
    VAE cache (s per clip, the stage's peak), 6 graphed rank-16 LoRA steps on
    the default preset (the eight attention projections of every block) on a
    bf16 base with every block checkpointed, the lyric ids of the sidecars in
    every batch, a replay bitwise against an eager step and the profiled
    replay held to the capture's launches; the true-CFG render of 47 s with
    ``validation_lyrics`` through ``CheckpointInferenceRuntime``, its WAV
    read back; one forward with the kernels against the plain attention; in a
    run that names the phase all 28 blocks built in memory and their graphed
    step timed.  Returns the launches per step of each kernel at the cross
    shape."""
    import gc

    import numpy as np
    import torch
    from scipy.io import wavfile

    from simpletuner_tpu_torch.inference import CheckpointInferenceRuntime, config_namespace
    from simpletuner_tpu_torch.models.ace_step import ACEStep, ACEStepConfig, ACEStepTransformer
    from simpletuner_tpu_torch.models.audio_vae import AudioAutoencoderKL, AudioVAEConfig
    from simpletuner_tpu_torch.models.checkpoint_layouts import acestep_checkpoint_shapes
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.t5 import T5Config, T5EncoderModel
    from simpletuner_tpu_torch.models.text_encoders import init_encoder
    from simpletuner_tpu_torch.models.weight_import import acestep_params_from_diffusers, save_safetensors

    start = time.perf_counter()
    work = paths["work"]
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(47)

    # (a) the flop count against the counter on two small configs
    tiny = ACEStepConfig.tiny()
    narrow = dataclasses.replace(tiny, latent_height=2, num_heads=3, head_dim=8, lyric_hidden=24, lyric_heads=3,
                                 num_layers=1)
    cases = []
    for arch_, (tokens, text, lyric) in ((tiny, (9, 5, 7)), (narrow, (6, 4, 3))):
        ids = torch.randint(0, arch_.lyric_vocab, (2, lyric), generator=torch.Generator().manual_seed(lyric))
        cases.append((arch_, (torch.zeros(2, arch_.latent_height, tokens, arch_.in_channels), torch.full((2,), 0.5),
                              torch.zeros(2, text, arch_.text_dim), torch.zeros(2, arch_.speaker_dim), ids,
                              torch.ones(2, lyric)), (tokens, text, lyric)))
    flop_checks = _flop_checks(_x3(acestep_flops), ACEStepTransformer, cases)
    full = ACEStepConfig()
    if (full.inner_dim, full.num_heads, full.head_dim, int(full.inner_dim * full.mlp_ratio), full.num_layers,
            full.lyric_hidden, full.lyric_depth, full.lyric_vocab, full.text_dim) != \
            (1536, 24, 64, 6144, 28, 1024, 6, 6681, 768):
        raise RuntimeError(f"not the JAX preset of ACE-Step: {full}")
    vae_cfg = AudioVAEConfig.ace()
    arch = dataclasses.replace(full, num_layers=ACE_FILE_BLOCKS)
    depth = arch.num_layers
    shapes = acestep_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 4e9 or written_before + PHASE47_WRITE_GB + _reserved(47) > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"ace_step: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the "
                           f"phase; it writes {PHASE47_WRITE_GB:.2f} GB of the {RUN_WRITE_TARGET_GB} GB a run may "
                           "write")

    # (b) the seeded files: the transformer (two e4m3 shards), umT5-base's width
    # at a cut depth (a umt5 file: a relative bias in every layer), the T5
    # tokenizer linked, the lyric vocab, four 47 s WAVs with captions and lyrics
    root = os.path.join(work, "ace_step")
    weights, write_s = _write_e4m3_transformer(root, shapes, gen)
    umt5 = T5Config(vocab_size=UMT5_VOCAB, d_model=768, d_kv=64, d_ff=2048, num_layers=UMT5_LAYERS, num_heads=12)
    with torch.device(dev):
        t5 = init_encoder(T5EncoderModel(umt5, torch.bfloat16), gen)
    t5_state = dict(t5.state_dict())
    for layer in range(1, UMT5_LAYERS):
        t5_state[f"encoder.block.{layer}.layer.0.SelfAttention.relative_attention_bias.weight"] = (
            torch.randn((umt5.relative_attention_num_buckets, umt5.num_heads), generator=gen, device=dev)
            * umt5.d_model ** -0.5).to(torch.bfloat16)
    os.makedirs(os.path.join(root, "text_encoder"))
    save_safetensors(t5_state, os.path.join(root, "text_encoder", "model.safetensors"))
    with open(os.path.join(root, "text_encoder", "config.json"), "w") as handle:
        json.dump({**dataclasses.asdict(umt5), "model_type": "umt5", "architectures": ["UMT5EncoderModel"],
                   "dense_act_fn": "gelu_new", "is_gated_act": True, "tie_word_embeddings": False}, handle)
    umt5_params = sum(v.numel() for v in t5_state.values())
    del t5, t5_state
    _link_tree(os.path.join(paths["flux_dir"], "tokenizer_2"), os.path.join(root, "tokenizer_2"))
    write_lyrics_vocab(os.path.join(root, "lyrics_utils", "vocab.json"))
    data = os.path.join(work, "ace_step_data")
    os.makedirs(data)
    t0 = time.perf_counter()
    for i in range(ACE_CLIPS):
        _write_wav(os.path.join(data, f"track_{i}.wav"), ACE_SECONDS, ACE_RATE, 2, 470 + i)
        with open(os.path.join(data, f"track_{i}.txt"), "w") as handle:
            handle.write(TRAIN_CAPTIONS[i])
        with open(os.path.join(data, f"track_{i}.lyrics.txt"), "w") as handle:
            handle.write(ACE_LYRICS)
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "blocks": [depth, full.num_layers],
             "outside_blocks": sum(math.prod(v) for k, v in shapes.items() if not k.startswith("transformer_blocks.")),
             "umt5": {"params": umt5_params, "width": 768, "layers": [UMT5_LAYERS, 12],
                      "vocab": [UMT5_VOCAB, 256384]},
             "wavs": {"clips": ACE_CLIPS, "seconds": ACE_SECONDS, "rate": ACE_RATE, "channels": 2,
                      "mb": sum(os.path.getsize(os.path.join(data, f)) for f in os.listdir(data)) / 1e6,
                      "write_s": time.perf_counter() - t0},
             "written_gb_before": written_before, "written_gb_after": _written_gb(), "free_gb_before": free / 1e9}

    # (c) the import, bitwise
    model = ModelRegistry.create("ace_step", config_namespace({"model_family": "ace_step", "model_type": "full"}))
    if model.arch != arch:
        raise RuntimeError(f"ace_step: the family builds {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()
    imported = _import_bitwise(model, module, root, weights, acestep_params_from_diffusers, file_bytes)
    params = sum(math.prod(v) for v in acestep_checkpoint_shapes(full).values())
    del weights, module, model
    gc.collect()
    torch.cuda.empty_cache()

    # (d) Trainer.run(): audio discovery, the text and audio VAE caches, the default LoRA preset
    cache, out = os.path.join(work, "ace_step_cache"), os.path.join(work, "ace_step_train")
    config = {"model_family": "ace_step", "model_type": "lora", "lora_rank": 16, "pretrained_model_name_or_path": root,
              "gradient_checkpointing": True, "optimizer": "adamw", "learning_rate": 1e-4, "lr_scheduler": "constant",
              "mixed_precision": "bf16", "text_encoder_precision": "bf16", "train_batch_size": 1, "vae_batch_size": 1,
              "max_train_steps": ACE_TRAIN_STEPS, "logging_steps": 1, "report_to": "jsonl", "seed": 42,
              "cache_dir": cache, "output_dir": out, "checkpoint_frozen_base": "reference",
              "data_backend_config": [
                  {"id": "tracks", "dataset_type": "audio", "type": "local", "instance_data_dir": data,
                   "caption_strategy": "textfile", "cache_dir_vae": os.path.join(cache, "vae"), "audio": {}},
                  {"id": "embeds", "dataset_type": "text_embeds", "type": "local", "default": True,
                   "cache_dir": os.path.join(cache, "text")}]}
    cross_key = f"{full.num_heads}x{ACE_TOKENS}x{ACE_KEYS}x{full.head_dim}"
    train_launches = _by_shape_per_step({cross_key: (depth, True)})

    def check(trainer) -> dict:
        bundle = trainer.data_plane.bundles["tracks"]
        buckets = sorted(bundle.metadata_backend.aspect_ratio_bucket_indices)
        tracks = [p for key in buckets for p in bundle.metadata_backend.aspect_ratio_bucket_indices[key]]
        cached = [bundle.vae_cache.load(p) for p in tracks]
        batch = trainer._example_batch()
        shapes_ = {k: tuple(v.shape) for k, v in batch.items() if k.startswith(("text", "lyrics", "latents"))}
        if trainer.model.arch != arch or buckets != [f"{ACE_SECONDS}s"] or len(tracks) != ACE_CLIPS or \
                not isinstance(trainer.vae, AudioAutoencoderKL) or trainer.vae.config != vae_cfg or \
                any(c.shape != (ACE_LATENTS, 8) or not np.isfinite(c).all() for c in cached) or \
                shapes_ != {"latents": (1, ACE_LATENTS, 8), "text_embeds": (1, ACE_TEXT, full.text_dim),
                            "lyrics_tokens": (1, ACE_LYRIC_KEYS), "lyrics_mask": (1, ACE_LYRIC_KEYS)} or \
                int(batch["lyrics_mask"].sum()) != ACE_LYRIC_IDS:
            raise RuntimeError(f"ace_step trainer: arch {trainer.model.arch}, buckets {buckets}, VAE "
                               f"{trainer.vae.config}, cached {[c.shape for c in cached]}, batch {shapes_}, lyric ids "
                               f"{batch.get('lyrics_mask', np.zeros(1)).sum()}")
        startup, stages = trainer.data_plane.startup_metrics, trainer.stage_report
        vae_s = startup.get("vae_cache_tracks_s")
        return {"buckets": buckets, "latents": list(cached[0].shape),
                "vae": "AudioVAEConfig.ace() (stereo, strides 4, 4, 4, 8: 512x; seeded from 0, bf16)",
                "cache": {"text_s": startup.get("text_cache_tracks_s"), "vae_s": vae_s,
                          "vae_s_per_clip": vae_s / ACE_CLIPS if vae_s else None,
                          "data_backend_stage_peak_gib": stages.get("init_data_backend", {}).get("peak_gib")},
                "lyric_ids": ACE_LYRIC_IDS, "lyric_keys": ACE_LYRIC_KEYS,
                **_graph_matches_eager(trainer, ("loss", "grad_norm"))}

    train = _train_graphed(config, kernels, ACE_TRAIN_STEPS, _totals(train_launches),
                           acestep_step_flops(arch, 1, ACE_TOKENS, ACE_TEXT, ACE_LYRIC_KEYS), check)
    if train["launches_per_step_by_shape"] != train_launches or train["lora_targets"] != sorted(
            f"{kind}_{p}" for kind in ("attn", "cross") for p in ("k", "proj", "q", "v")):
        raise RuntimeError(f"ace_step trainer: launches per step by shape {train['launches_per_step_by_shape']}, "
                           f"targets {train['lora_targets']}")
    train.update({"base": "bf16", "remat": "every block", "lora_rank": 16, "lora_preset": "attn_qkv+linear_qkv",
                  "flop_checks": flop_checks})
    shutil.rmtree(out, ignore_errors=True)

    # (e) the true-CFG render of 47 s with validation_lyrics, its WAV read back
    config_path = os.path.join(work, "ace_step_render.json")
    with open(config_path, "w") as handle:
        json.dump({"model_family": "ace_step", "model_type": "full", "pretrained_model_name_or_path": root,
                   "mixed_precision": "bf16", "text_encoder_precision": "bf16", "seed": 42, "validation_seed": 42,
                   "validation_guidance": ACE_GUIDANCE, "validation_audio_duration": ACE_SECONDS,
                   "validation_audio_sample_rate": ACE_RATE, "validation_lyrics": ACE_LYRICS}, handle)
    t0 = time.perf_counter()
    runtime = CheckpointInferenceRuntime(config_path=config_path, output=os.path.join(work, "ace_step_render"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    timed = _timed_render(runtime, kernels, ACE_PROMPT, ACE_GUIDANCE)
    wav = os.path.join(work, "ace_step_render", "validation", "step_0_0.wav")
    rate, samples = wavfile.read(wav)
    forward_s = timed["forward_s"]
    if timed["rendered"] != [] or timed["launches"] != {"flash_fwd": depth * 2 * STEPS, "flash_bwd_dq": 0,
                                                        "flash_bwd_dkv": 0} or \
            timed["finite"] != [True] or len(forward_s) != 2 * STEPS or rate != ACE_RATE or \
            samples.dtype != np.int16 or samples.shape != (ACE_LATENTS * vae_cfg.compression, 2) or \
            not samples.any():
        raise RuntimeError(f"ace_step render: paths {timed['rendered']}, launches {timed['launches']}, finite "
                           f"{timed['finite']}, {len(forward_s)} forwards, the WAV {rate} Hz {samples.shape} "
                           f"{samples.dtype}")
    render = {"init_s": init_s, "render_s": timed["render_s"], "steps": STEPS, "guidance": ACE_GUIDANCE,
              "seconds": ACE_SECONDS, "latents": ACE_LATENTS, "tokens": ACE_TOKENS,
              "s_per_cfg_step": sum(forward_s[2:]) / (len(forward_s) - 2) * 2, "forward_s": forward_s,
              "vae_decode_s": timed["decode_s"][0], "peak_gib": timed["peak_gib"], "launches": timed["launches"],
              "launches_by_shape": timed["launches_by_shape"], "wav": os.path.basename(wav),
              "wav_samples": list(samples.shape), "wav_rate": rate, "wav_bytes": os.path.getsize(wav),
              "returned_paths": timed["rendered"]}

    # (f) the parity forward at the file's depth with the caption, the lyrics and the mel layout
    module, model = runtime.module, runtime.model
    batch = {"latents": torch.zeros((1, ACE_LATENTS, 8), device=dev)}
    for key, value in model.collate_text_embeds(model.encode_text([ACE_PROMPT])).items():
        batch[key] = torch.as_tensor(value, device=dev)
    ids, mask = model.lyrics_tokenizer.tokenize_batch([ACE_LYRICS])
    batch.update({"lyrics_tokens": torch.as_tensor(ids, device=dev), "lyrics_mask": torch.as_tensor(mask, device=dev)})
    noise = torch.randn((1, ACE_LATENTS, 8), generator=gen, device=dev)
    for kernel in kernels:
        kernel.launches = 0
        kernel.shape_launches.clear()
    parity = _parity_forward(model, module, batch, noise, ACE_SIGMA)
    parity["launches_by_shape"] = _per_shape(kernels)
    # the kernel forward, then cuda_ms's warm-up and 3 timed calls; the plain one launches nothing
    if parity["launches_by_shape"]["flash_fwd"] != {cross_key: 5 * depth} or \
            tuple(ids.shape) != (1, ACE_LYRIC_KEYS) or int(mask.sum()) != ACE_LYRIC_IDS:
        raise RuntimeError(f"ace_step parity: launches {parity['launches_by_shape']}, lyric ids {ids.shape} "
                           f"{mask.sum()}")

    # (g) the encoder's four strided convs on one 47 s clip (the render's VAE, seeded 0):
    # conv1d, the card's path, against unfolded_conv, the CPU's bf16 path; each level's
    # input is the conv1d path's, and the two outputs agree within a bf16 rounding
    from simpletuner_tpu_torch.models.audio_vae import unfolded_conv

    encoder = runtime.vae.encoder
    _, clip = wavfile.read(os.path.join(data, sorted(f for f in os.listdir(data) if f.endswith(".wav"))[0]))
    strided = {"conv1d_ms": [], "unfolded_ms": [], "rel_l2": [], "shapes": []}
    with torch.no_grad():
        h = encoder.stem(torch.as_tensor(clip.astype(np.float32) / 32768.0, device=dev).T[None].to(encoder.dtype))
        for level in range(len(vae_cfg.strides)):
            pool, h = getattr(encoder, f"down_{level}_pool"), getattr(encoder, f"down_{level}_res")(h)
            strided["conv1d_ms"].append(cuda_ms(lambda: pool(h), 5))
            strided["unfolded_ms"].append(cuda_ms(lambda: unfolded_conv(pool, h), 5))
            out, product = pool(h), unfolded_conv(pool, h)
            strided["rel_l2"].append(rel_l2(out, product))
            strided["shapes"].append([list(h.shape), list(out.shape), pool.kernel_size[0], pool.stride[0]])
            h = out
    strided["conv1d_total_ms"], strided["unfolded_total_ms"] = sum(strided["conv1d_ms"]), sum(strided["unfolded_ms"])
    if max(strided["rel_l2"]) > 2 ** -7:
        raise RuntimeError(f"ace_step audio VAE: conv1d and the unfolded product differ on the card: {strided}")
    del runtime, module, model, batch, noise, encoder, h, out, product
    gc.collect()
    torch.cuda.empty_cache()

    # (g) in a run that names the phase: all 28 blocks built in memory, their graphed step
    full_depth = None
    if full_in_memory:
        deep = ACEStep(config_namespace(_graph_train_values("ace_step", ACE_FULL_STEPS)), arch=full)
        deep_batch = {"latents": torch.randn((1, ACE_LATENTS, 8), generator=gen, device=dev),
                      "text_embeds": torch.randn((1, ACE_TEXT, full.text_dim), generator=gen, device=dev),
                      "lyrics_tokens": torch.as_tensor(ids, device=dev), "lyrics_mask": torch.as_tensor(mask, device=dev)}
        deep_launches = _by_shape_per_step({cross_key: (full.num_layers, True)})
        full_depth = _graph_vs_eager(deep, _drawn_in_memory(deep, gen), deep_batch, kernels, ACE_FULL_STEPS,
                                     _totals(deep_launches),
                                     acestep_step_flops(full, 1, ACE_TOKENS, ACE_TEXT, ACE_LYRIC_KEYS))
        if full_depth["launches_per_step_by_shape"] != deep_launches:
            raise RuntimeError(f"ace_step 28 blocks: launches per step by shape "
                               f"{full_depth['launches_per_step_by_shape']}")
        full_depth.update({"blocks": [full.num_layers] * 2, "base": "int8 (built in memory)",
                           "quantized_matmul": "full", "remat": "every block", "lora_rank": 16})
        del deep, deep_batch
        gc.collect()
        torch.cuda.empty_cache()
    for name in ("ace_step", "ace_step_data", "ace_step_cache", "ace_step_render"):
        shutil.rmtree(os.path.join(work, name), ignore_errors=True)
    phase("47 ace_step", config="ACE-Step/ACE-Step-v1-3.5B transformer as the JAX preset ACEStepConfig() builds it",
          params=params, params_per_block=sum(math.prod(v) for k, v in shapes.items()
                                              if k.startswith("transformer_blocks.0.")),
          hidden=full.inner_dim, heads=[full.num_heads, full.head_dim],
          depth={"file": [depth, full.num_layers], "train": [depth, full.num_layers],
                 "in_memory": [full.num_layers if full_in_memory else 0, full.num_layers],
                 "umt5_layers": [UMT5_LAYERS, 12]},
          audio={"seconds": ACE_SECONDS, "rate": ACE_RATE, "samples": ACE_SECONDS * ACE_RATE, "latents": ACE_LATENTS,
                 "mel_layout": [16, ACE_TOKENS]},
          tokens={"latent": ACE_TOKENS, "text": ACE_TEXT, "lyric_ids": ACE_LYRIC_IDS, "cross_keys": ACE_KEYS},
          files=files, imported=imported, train=train, render=render, parity=parity, vae_strided_convs=strided,
          full_depth=full_depth, kernel_cases=kernel_cases, allocated_gib_before_phase=baseline_gib, seconds=time.perf_counter() - start,
          device=device)
    return {"ace_cross": {k: v.get(cross_key, 0) for k, v in train_launches.items()}}


def wan_s2v_phase(paths: dict, kernels, device: str, kernel_cases: dict) -> dict:
    """Phase 48: Wan-S2V at the ``s2v-14b`` width (``WanConfig.b14()``): a seeded
    e4m3 file in Wan's layout at ``S2V_FILE_BLOCKS`` of 40 blocks imported
    through ``load_wan_params`` and held bitwise, phase 15's T5-XXL and
    tokenizer linked as phase 23 links them, phase 42's two 832 x 480 x 81
    clips and their video latents linked (written here in a run without
    phase 42) beside seeded same-stem 16 kHz WAVs of 5 s; ``Trainer.run()``
    with the dataset's ``audio: {pair_with_video: true}``: 6 graphed rank-16
    LoRA steps on the attention projections (the cross-attention over 512
    text and 128 audio keys), the collated ``audio_embeds`` held bitwise to a
    host recomputation from the clip's WAV, a replay bitwise against an eager
    step and the profiled replay held to the capture's launches by shape; the
    text-only true-CFG render (17 frames at 480 px square) through
    ``CheckpointInferenceRuntime``; one forward with audio features against
    the plain attention on a 17-frame clip.  Last, the run's writes against
    the target.  Returns the launches per step of each kernel at the
    cross-attention over the text and audio keys."""
    import gc

    import numpy as np
    import torch

    from simpletuner_tpu_torch.data.audio import load_audio, waveform_features
    from simpletuner_tpu_torch.data.backends.local import LocalDataBackend
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import wan_checkpoint_shapes
    from simpletuner_tpu_torch.models.registry import ModelRegistry
    from simpletuner_tpu_torch.models.wan import WanConfig
    from simpletuner_tpu_torch.models.weight_import import wan_params_from_diffusers

    start = time.perf_counter()
    work = paths["work"]
    gc.collect()
    torch.cuda.empty_cache()
    baseline_gib = torch.cuda.memory_allocated() / 2**30
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(48)
    full = WanConfig.b14()
    if (full.hidden_size, full.depth, full.num_heads, full.head_dim, full.text_dim) != (5120, 40, 40, 128, 4096):
        raise RuntimeError(f"not the JAX preset of Wan 14B: {full}")
    arch = dataclasses.replace(full, depth=S2V_FILE_BLOCKS)
    depth = arch.depth
    latent_shape = (WAN_FRAMES - 1) // 4 + 1, WAN_HEIGHT // 8, WAN_WIDTH // 8
    shapes = wan_checkpoint_shapes(arch)
    file_bytes = sum(math.prod(shape) for shape in shapes.values())  # e4m3: one byte each
    written_before, free = _written_gb(), shutil.disk_usage(work).free
    if free < file_bytes + 4e9 or written_before + PHASE48_WRITE_GB + _reserved(48) > RUN_WRITE_TARGET_GB:
        raise RuntimeError(f"wan_s2v: {free / 1e9:.1f} GB free and {written_before:.1f} GB written before the "
                           f"phase; it writes {PHASE48_WRITE_GB:.2f} GB of the {RUN_WRITE_TARGET_GB} GB a run may "
                           "write")

    # (b) the transformer, T5-XXL and its tokenizer linked, the clips (with their latents) and their WAVs
    root = os.path.join(work, "wan_s2v")
    weights, write_s = _write_e4m3_transformer(root, shapes, gen)
    for source, target in (("text_encoder_2", "text_encoder"), ("tokenizer_2", "tokenizer_2")):
        _link_tree(os.path.join(paths["flux_dir"], source), os.path.join(root, target))
    files = {"transformer_gb": file_bytes / 1e9, "transformer_dtype": "float8_e4m3fn", "write_s": write_s,
             "write_gb_per_s": file_bytes / write_s / 1e9, "blocks": [depth, full.depth],
             "t5_xxl": {"linked_from_phase": 15, "blocks": [T5_FILE_LAYERS, 24]}}
    data, cache = os.path.join(work, "wan_s2v_data"), os.path.join(work, "wan_s2v_cache")
    clips = paths.get("lv_clips")
    if clips and os.path.isdir(clips):
        # without phase 42's bucket index, which lists its own paths: the clips are discovered
        # here, beside their WAVs (the latents' cache files are named by the file's stem)
        shutil.copytree(clips, data, copy_function=os.link, ignore=shutil.ignore_patterns("aspect_ratio_bucket_*"))
        _link_tree(os.path.join(work, "longcat_video_cache", "vae"), os.path.join(cache, "vae"))
        files["clips"] = {"linked_from_phase": 42, "with_vae_latents": True}
    else:
        files.update(_write_clips(data, LV_CLIPS, WAN_FRAMES, WAN_HEIGHT, WAN_WIDTH, 16, 42))
    stems = sorted(os.path.splitext(f)[0] for f in os.listdir(data) if f.endswith(".mp4"))
    for i, stem in enumerate(stems):
        _write_wav(os.path.join(data, f"{stem}.wav"), S2V_AUDIO_SECONDS, S2V_AUDIO_RATE, 1, 480 + i)
    files.update({"wavs": {"clips": len(stems), "seconds": S2V_AUDIO_SECONDS, "rate": S2V_AUDIO_RATE},
                  "written_gb_before": written_before, "written_gb_after": _written_gb(), "free_gb_before": free / 1e9})

    # (c) the import through load_wan_params, bitwise
    model = ModelRegistry.create("wan_s2v", config_namespace({"model_family": "wan_s2v", "model_type": "full"}))
    if model.arch != arch or model.flavour != "s2v-14b":
        raise RuntimeError(f"wan_s2v: the family builds {model.flavour} {model.arch}, not {arch}")
    with torch.device(dev):
        module = model.create_module()
    imported = _import_bitwise(model, module, root, weights, wan_params_from_diffusers, file_bytes)
    params = sum(math.prod(v) for v in wan_checkpoint_shapes(full).values())
    del weights, module, model
    gc.collect()
    torch.cuda.empty_cache()

    # (d) Trainer.run() with each clip's WAV paired as audio features
    out = os.path.join(work, "wan_s2v_train")
    config = _video_config("wan_s2v", root, data, cache, out, WAN_FRAMES, S2V_TRAIN_STEPS,
                           lora_target_modules=["to_q", "to_k", "to_v", "to_out.0"])
    config["data_backend_config"][0]["audio"] = {"pair_with_video": True, "max_feature_frames": S2V_FRAMES}
    self_key = f"{full.num_heads}x{WAN_TOKENS}x{WAN_TOKENS}x128"
    cross_key = f"{full.num_heads}x{WAN_TOKENS}x{S2V_KEYS}x128"
    train_launches = _by_shape_per_step({self_key: (depth, True), cross_key: (depth, True)})

    def check(trainer) -> dict:
        iterator = trainer.data_plane.iterator
        snapshot = iterator.save_state()
        raw = iterator.next_batch()
        iterator.load_state(snapshot)
        path = raw["image_paths"][0]
        wave = load_audio(LocalDataBackend("a", data), os.path.splitext(path)[0] + ".wav", S2V_AUDIO_RATE)
        feats = waveform_features(wave, sample_rate=S2V_AUDIO_RATE)[:S2V_FRAMES]
        expected = np.pad(feats, ((0, S2V_FRAMES - feats.shape[0]), (0, 0)))
        if trainer.model.arch != arch or raw["audio_embeds"].shape != (1, S2V_FRAMES, 64) or \
                not np.array_equal(raw["audio_embeds"][0], expected) or raw["latents"].shape != (1,) + latent_shape + (16,):
            raise RuntimeError(f"wan_s2v trainer: arch {trainer.model.arch}, batch {({k: getattr(v, 'shape', None) for k, v in raw.items()})}")
        return {"audio_embeds": list(raw["audio_embeds"].shape), "audio_embeds_equal_host_recomputation": True,
                "audio_frames_from_wav": int(waveform_features(wave, sample_rate=S2V_AUDIO_RATE).shape[0]),
                "cache": {"text_s": trainer.data_plane.startup_metrics.get("text_cache_clips_s"),
                          "vae_s": trainer.data_plane.startup_metrics.get("vae_cache_clips_s")},
                **_graph_matches_eager(trainer, ("loss", "grad_norm"))}

    train = _train_graphed(config, kernels, S2V_TRAIN_STEPS, _totals(train_launches),
                           wan_step_flops(arch, 1, WAN_TOKENS, S2V_KEYS), check)
    if train["launches_per_step_by_shape"] != train_launches:
        raise RuntimeError(f"wan_s2v trainer: launches per step by shape {train['launches_per_step_by_shape']}")
    train.update({"base": "bf16", "remat": "every block", "lora_rank": 16,
                  "lora_targets_by_name": ["to_q", "to_k", "to_v", "to_out.0"]})
    shutil.rmtree(out, ignore_errors=True)

    # (e) the text-only true-CFG render, then the parity forward with audio features on 17 frames
    render, runtime = _video_render(work, "wan_s2v", root, "wan_s2v", kernels, S2V_PROMPT, S2V_GUIDANCE,
                                    WAN_RENDER_SIZE, S2V_RENDER_FRAMES, 2 * depth)
    module, model = runtime.module, runtime.model
    if model.arch != arch:
        raise RuntimeError(f"wan_s2v: the runtime built {model.arch}")
    parity_latent = ((WAN_PARITY_FRAMES - 1) // 4 + 1,) + latent_shape[1:]
    batch = _text_batch(model, S2V_PROMPT, (1,) + parity_latent + (16,), dev)
    batch["audio_embeds"] = torch.randn((1, S2V_FRAMES, 64), generator=gen, device=dev).abs()
    model.text_encoders = []
    gc.collect()
    torch.cuda.empty_cache()
    noise = torch.randn((1,) + parity_latent + (16,), generator=gen, device=dev)
    for kernel in kernels:
        kernel.launches = 0
        kernel.shape_launches.clear()
    parity = _parity_forward(model, module, batch, noise, WAN_SIGMA)
    parity["launches_by_shape"] = _per_shape(kernels)
    tokens = parity_latent[0] * (parity_latent[1] // 2) * (parity_latent[2] // 2)
    parity_cross = f"{full.num_heads}x{tokens}x{S2V_KEYS}x128"
    if parity["launches_by_shape"]["flash_fwd"].get(parity_cross) != 5 * depth:
        raise RuntimeError(f"wan_s2v parity: launches {parity['launches_by_shape']}")
    parity["frames"], parity["tokens"] = WAN_PARITY_FRAMES, tokens
    del runtime, module, model, batch, noise
    gc.collect()
    torch.cuda.empty_cache()
    for name in ("wan_s2v", "wan_s2v_data", "wan_s2v_cache", "wan_s2v_render", "longcat_video_data",
                 "longcat_video_cache"):
        shutil.rmtree(os.path.join(work, name), ignore_errors=True)
    writes = check_run_writes()  # the last phase
    phase("48 wan_s2v", config="Wan-AI/Wan2.2-S2V-14B as the JAX family builds it (WanConfig.b14())", params=params,
          params_per_block=sum(math.prod(v) for k, v in shapes.items() if k.startswith("blocks.0.")),
          hidden=full.hidden_size, heads=[full.num_heads, full.head_dim],
          depth={"file": [depth, full.depth], "train": [depth, full.depth]},
          clip=[WAN_FRAMES, WAN_HEIGHT, WAN_WIDTH], latents=list(latent_shape),
          tokens={"video": WAN_TOKENS, "text": WAN_TEXT, "audio_frames": S2V_FRAMES, "cross_keys": S2V_KEYS},
          files=files, imported=imported, train=train, render=render, parity=parity, kernel_cases=kernel_cases,
          allocated_gib_before_phase=baseline_gib, seconds=time.perf_counter() - start, device=device, **writes)
    return {"s2v_cross": {k: v.get(cross_key, 0) for k, v in train_launches.items()}}


def int8_cases() -> None:
    """Phase 10: torch._int_mm exact at the Flux shapes, int8_dynamic_dot
    against its float64-contraction plain version, and times."""
    import torch
    import torch.nn.functional as F

    from simpletuner_tpu_torch.training.quantization import (
        _dynamic_quantize, int8_dynamic_dot, int8_matmul, quantize_weight,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)

    def codes(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, device=dev, generator=gen)

    # the plain version shares nothing with the port's but the stored weight
    def plain_quantize(v):
        v = v.float()
        scales = torch.clamp_min(v.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-12)
        return torch.round(v / scales).to(torch.int8), scales

    def plain_dot(x, w_q, w_scale):
        x_q, x_scales = plain_quantize(x)
        acc = x_q.double() @ w_q.double().t()
        return (acc * x_scales.double() * w_scale.double()).to(x.dtype)

    def plain_dx(dy, w_q, w_scale):
        dy_q, dy_scales = plain_quantize(dy.float() * w_scale.float())
        return ((dy_q.double() @ w_q.double()) * dy_scales.double()).to(dy.dtype)

    def rel_max(a, b):
        a, b = a.detach().float(), b.detach().float()
        return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())

    shapes = {}
    for k, n in INT8_SHAPES:
        a, w, dy_q = codes(INT8_ROWS, k), codes(n, k), codes(INT8_ROWS, n)  # w: the stored (out, in)
        forward = int8_matmul(a, w.t())
        exact = torch.equal(forward.double(), a.double() @ w.double().t())
        exact &= torch.equal(int8_matmul(a[:1], w.t()).double(), a[:1].double() @ w.double().t())
        exact &= torch.equal(int8_matmul(dy_q, w.t().contiguous().t()).double(), dy_q.double() @ w.double())
        exact &= torch.equal(int8_matmul(dy_q[:1], w.t().contiguous().t()).double(), dy_q[:1].double() @ w.double())
        if not exact:
            raise RuntimeError(f"int8 product at (m, k, n) = ({INT8_ROWS}, {k}, {n}) is not exact")
        del forward

        stored = quantize_weight(torch.randn(n, k, device=dev, generator=gen) * k ** -0.5, "int8")
        w_q, w_scale = stored["weight"], stored["weight_scale"]
        x = torch.randn(INT8_ROWS, k, device=dev, generator=gen).bfloat16().requires_grad_(True)
        dy = torch.randn(INT8_ROWS, n, device=dev, generator=gen).bfloat16()
        errors = {}
        for rows in (INT8_ROWS, 1):
            xr = x[:rows].detach().requires_grad_(True)
            y = int8_dynamic_dot(xr, w_q, w_scale, True)
            (dx,) = torch.autograd.grad(y, xr, dy[:rows])
            errors[rows] = {"y": rel_max(y, plain_dot(xr.detach(), w_q, w_scale)),
                            "dx": rel_max(dx, plain_dx(dy[:rows], w_q, w_scale))}
            if max(errors[rows].values()) > DOT_REL:
                raise RuntimeError(f"int8_dynamic_dot at ({rows}, {k}, {n}): {errors[rows]} (<= {DOT_REL})")

        w_bf16 = (w_q.float() * w_scale[:, None]).bfloat16()
        y = int8_dynamic_dot(x, w_q, w_scale, True)
        y_bf16 = F.linear(x, w_bf16)
        w_t = w.t()
        shapes[f"{k}x{n}"] = {
            "exact": exact, "rel_err": errors,
            "int_mm_ms": cuda_ms(lambda: int8_matmul(a, w_t), 10),
            "int_mm_dx_ms": cuda_ms(lambda: int8_matmul(dy_q, w.t().contiguous().t()), 10),
            "int_mm_dx_row_major_ms": cuda_ms(lambda: torch._int_mm(dy_q, w), 3),
            "weight_transpose_ms": cuda_ms(lambda: w.t().contiguous(), 10),
            "bf16_mm_ms": cuda_ms(lambda: F.linear(x.detach(), w_bf16), 10),
            "bf16_mm_dx_ms": cuda_ms(lambda: dy @ w_bf16, 10),
            "quantize_ms": cuda_ms(lambda: _dynamic_quantize(x.detach()), 10),
            "dot_fwd_ms": cuda_ms(lambda: int8_dynamic_dot(x.detach(), w_q, w_scale, True), 10),
            "dot_dx_ms": cuda_ms(lambda: torch.autograd.grad(y, x, dy, retain_graph=True), 10),
            "linear_fwd_ms": cuda_ms(lambda: F.linear(x.detach(), w_bf16), 10),
            "linear_dx_ms": cuda_ms(lambda: torch.autograd.grad(y_bf16, x, dy, retain_graph=True), 10),
        }
        del a, w, w_t, dy_q, x, dy, y, y_bf16, w_bf16
        torch.cuda.empty_cache()
    phase("10 int8 products", rows=INT8_ROWS, tol={"int_mm": "exact", "dot_rel": DOT_REL}, shapes=shapes)


def _rss_gib() -> dict:
    """The process's resident host memory now and its peak so far, GiB."""
    import resource

    with open("/proc/self/status") as handle:
        now = next(int(line.split()[1]) for line in handle if line.startswith("VmRSS:"))
    return {"now": now / 2**20, "peak": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20}


def _written_gb() -> float:
    """GB this process has written so far (``wchar`` of /proc/self/io: every
    byte handed to a write call); the card's machine ends a run that writes
    more than 45 GiB in all."""
    with open("/proc/self/io") as handle:
        return next(int(line.split()[1]) for line in handle if line.startswith("wchar:")) / 1e9


def _filesystem(path: str) -> str:
    """The type of the filesystem that holds ``path`` (from /proc/mounts)."""
    path, best, kind = os.path.realpath(path), "", "unknown"
    with open("/proc/mounts") as handle:
        for line in handle:
            fields = line.split()
            if len(fields) > 2 and (path + "/").startswith(fields[1].rstrip("/") + "/") and len(fields[1]) > len(best):
                best, kind = fields[1], fields[2]
    return kind


def seeded_weights(shapes: dict, gen) -> dict:
    """bf16 tensors on the card: N(0, 1/fan_in) matrices and convs, 1 + N(0, 0.1) norm scales, N(0, 0.01) biases."""
    import torch

    out = {}
    for name, shape in shapes.items():
        draw = torch.randn(shape, generator=gen, device=gen.device)
        if len(shape) > 1:
            draw = draw / math.sqrt(math.prod(shape[1:]))
        elif name.endswith(".weight"):  # the 1-D weights are norm scales
            draw = 1.0 + 0.1 * draw
        else:
            draw = 0.01 * draw
        out[name] = draw.to(torch.bfloat16)
    return out


def weight_import(work: str) -> dict:
    """Phase 14: write seeded checkpoints with the port's writer, load each
    onto the card, compare; returns the checkpoint paths for phases 15-16."""
    import dataclasses

    import torch

    from simpletuner_tpu_torch.bench import flagship_config
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.checkpoint_layouts import (
        flux_bfl_from_diffusers, flux_checkpoint_shapes, vae_checkpoint_shapes,
    )
    from simpletuner_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel, load_clip_text
    from simpletuner_tpu_torch.models.flux import Flux, FluxConfig
    from simpletuner_tpu_torch.models.layers import init_adapters, lora_parameters
    from simpletuner_tpu_torch.models.text_encoders import init_encoder
    from simpletuner_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from simpletuner_tpu_torch.models.vae_import import load_vae_params
    from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
    from simpletuner_tpu_torch.models.weight_import import load_transformer_params, save_safetensors
    from simpletuner_tpu_torch.training.lora import load_lora_safetensors, save_lora_safetensors

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    start = time.perf_counter()
    rss_before = _rss_gib()

    def seeded(shapes):
        return seeded_weights(shapes, gen)

    def in_cut(name):
        for prefix, depth in (("transformer_blocks.", IMPORT_DOUBLE), ("single_transformer_blocks.", IMPORT_SINGLE)):
            if name.startswith(prefix):
                return int(name.split(".")[1]) < depth
        return True

    # Flux at full width and phase 17's depth (diffusers names; ``train_blocks``),
    # drawn on the card; the cut depth is its first blocks, so the two imports
    # share those tensors
    full_arch = dataclasses.replace(FluxConfig(), **dict(zip(("depth_double", "depth_single"), train_blocks())))
    weights = seeded(flux_checkpoint_shapes(full_arch))
    full_bytes = sum(t.numel() for t in weights.values())  # as fp8
    free = shutil.disk_usage(work).free
    if free < full_bytes + 4e9:
        raise RuntimeError(f"weight import: {free / 1e9:.1f} GB free under {work}, the checkpoints need "
                           f"{(full_bytes + 4e9) / 1e9:.1f} GB")
    cut = {k: v for k, v in weights.items() if in_cut(k)}
    arch = dataclasses.replace(full_arch, depth_double=IMPORT_DOUBLE, depth_single=IMPORT_SINGLE)
    flux_dir = os.path.join(work, "flux")
    os.makedirs(os.path.join(flux_dir, "transformer"))
    names = sorted(cut)
    t0 = time.perf_counter()
    for shard, part in enumerate((names[: len(names) // 2], names[len(names) // 2:])):
        save_safetensors({k: cut[k] for k in part}, os.path.join(
            flux_dir, "transformer", f"diffusion_pytorch_model-0000{shard + 1}-of-00002.safetensors"))
    bfl_path = os.path.join(work, "flux1-dev-cut.safetensors")
    save_safetensors(flux_bfl_from_diffusers(cut), bfl_path)
    write_s = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in cut.values())
    del cut

    model = Flux(config_namespace(flagship_config("attn", "none", "off")), arch=arch)
    loads, modules = {}, {}
    for layout, path in (("bfl", bfl_path), ("diffusers", flux_dir)):
        with torch.device(dev):
            module = init_adapters(model.create_module(), gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        load_transformer_params(model, module, path)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        loads[layout] = {"s": seconds, "gb_per_s": nbytes / seconds / 1e9,
                         "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30}
        modules[layout] = module
    bfl_state, diffusers_state = modules["bfl"].state_dict(), modules["diffusers"].state_dict()
    base = [k for k in bfl_state if k.rsplit(".", 1)[-1] not in ("lora_A", "lora_B")]
    unequal = [k for k in base if not torch.equal(bfl_state[k], diffusers_state[k])]
    if unequal or not base:
        raise RuntimeError(f"weight import: the BFL and diffusers modules differ at {unequal[:8]}")

    # a rank-16 adapter, saved by the port and loaded back into the other module
    with torch.no_grad():
        for param in lora_parameters(modules["bfl"]).values():
            param.normal_(0.0, 0.01, generator=gen)
    lora_path = os.path.join(work, "pytorch_lora_weights.safetensors")
    save_lora_safetensors(model, modules["bfl"], lora_path)
    missing = load_lora_safetensors(model, lora_path, modules["diffusers"])
    saved, loaded = lora_parameters(modules["bfl"]), lora_parameters(modules["diffusers"])
    lora_equal = not missing and all(torch.equal(saved[k], loaded[k]) for k in saved)
    if not lora_equal:
        raise RuntimeError(f"LoRA round trip: missing {missing[:4]}, or tensors differ")
    del modules, module, diffusers_state

    # phase 17's depth as one fp8 (e4m3) BFL file, as the published fp8 Flux
    # files are (11.9 GB at full depth, 1.3 GB at TRAIN_CUT_BLOCKS): the card's
    # machine ends a run that writes more than 45 GiB in all, deleted files
    # included.  Imported once; the file was just written, so its pages are
    # read from the page cache
    full_path = os.path.join(work, "flux1-dev-fp8.safetensors")
    t0 = time.perf_counter()
    save_safetensors({k: v.to(torch.float8_e4m3fn) for k, v in flux_bfl_from_diffusers(weights).items()}, full_path)
    full_write_s = time.perf_counter() - t0
    del weights
    torch.cuda.empty_cache()
    full_model = Flux(config_namespace(flagship_config("attn", "none", "off")), arch=full_arch)
    with torch.device(dev):
        full_module = init_adapters(full_model.create_module(), gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rss_full_before = _rss_gib()
    t0 = time.perf_counter()
    load_transformer_params(full_model, full_module, full_path)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    full_state = full_module.state_dict()
    # the cut module's tensors rounded to e4m3 (an elementwise rounding commutes
    # with the importer's transposes, permutations and concatenations)
    full_unequal = [k for k in base if not torch.equal(
        full_state[k], bfl_state[k].to(torch.float8_e4m3fn).to(full_state[k].dtype))]
    if full_unequal:
        raise RuntimeError(f"weight import: the fp8 file's module differs from the cut one at {full_unequal[:8]}")
    full = {"blocks": [full_arch.depth_double, full_arch.depth_single], "of": [19, 38], "params": full_bytes,
            "dtype": "F8_E4M3",
            "gb": full_bytes / 1e9, "file_gb": os.path.getsize(full_path) / 1e9, "write_s": full_write_s,
            "load_s": full_s, "gb_per_s": full_bytes / full_s / 1e9,
            "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30,
            "host_rss_gib": {"before": rss_full_before, "after": _rss_gib()}, "cut_tensors_bitwise": len(base)}
    del full_module, full_state, bfl_state
    torch.cuda.empty_cache()

    # the Flux VAE (diffusers layout, modern attention) and CLIP-L, full size
    with torch.device(dev):
        vae = AutoencoderKL(VAEConfig.flux(), torch.bfloat16)
    vae_dir = os.path.join(flux_dir, "vae")
    os.makedirs(vae_dir)
    vae_weights = seeded(vae_checkpoint_shapes(vae))
    save_safetensors(vae_weights, os.path.join(vae_dir, "diffusion_pytorch_model.safetensors"))
    t0 = time.perf_counter()
    load_flax_params(vae, load_vae_params(vae, flux_dir)["params"])
    torch.cuda.synchronize()
    vae_s = time.perf_counter() - t0
    file_tensors = list(vae_weights.values())
    vae_equal = all(torch.equal(t, f.reshape(t.shape).to(dev)) for t, f in zip(vae.state_dict().values(), file_tensors))
    clip_dir = os.path.join(flux_dir, "text_encoder")
    os.makedirs(clip_dir)
    with torch.device(dev):
        clip = init_encoder(CLIPTextModel(CLIPTextConfig.clip_l(), torch.bfloat16), gen)
    save_safetensors(clip.state_dict(), os.path.join(clip_dir, "model.safetensors"))
    with open(os.path.join(clip_dir, "config.json"), "w") as handle:
        json.dump({**dataclasses.asdict(CLIPTextConfig.clip_l()), "architectures": ["CLIPTextModel"]}, handle)
    t0 = time.perf_counter()
    loaded_clip = load_clip_text(clip_dir, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    clip_s = time.perf_counter() - t0
    clip_equal = all(torch.equal(a, b) for a, b in zip(clip.state_dict().values(), loaded_clip.state_dict().values()))
    if not (vae_equal and clip_equal):
        raise RuntimeError(f"weight import: VAE equal {vae_equal}, CLIP-L equal {clip_equal}")
    phase("14 weight import", flux_blocks=[IMPORT_DOUBLE, IMPORT_SINGLE], hidden=arch.hidden_size,
          flux_params=nbytes // 2, flux_gb=nbytes / 1e9, write_s=write_s, load=loads, fp8_file=full,
          work_fs=_filesystem(work),
          free_gb_before=free / 1e9, written_gb=_written_gb(),
          bfl_equals_diffusers_bitwise=True, base_tensors=len(base), lora_round_trip_bitwise=True,
          lora_tensors=len(saved), vae_params=sum(p.numel() for p in vae.parameters()), vae_load_s=vae_s,
          vae_bitwise=True, clip_params=sum(p.numel() for p in clip.parameters()), clip_load_s=clip_s,
          clip_bitwise=True, host_rss_gib={"before": rss_before, "after": _rss_gib()},
          seconds=time.perf_counter() - start)
    del vae, clip, loaded_clip
    torch.cuda.empty_cache()
    return {"work": work, "flux_dir": flux_dir, "clip_dir": clip_dir, "flux_file": full_path}


def write_tokenizers(root: str, words) -> None:
    """Tokenizer files in the layout of a diffusers Flux dir, for seeded
    encoders: CLIP's BPE files (``tokenizer/``: one token per character, no
    merges, CLIP's bos/eos ids) and T5's (``tokenizer_2/tokenizer.json``: a
    unigram model over ``words`` and single characters, with T5's pad/eos/unk
    ids, its metaspace pre-tokenizer and the eos appended)."""
    import string

    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, processors

    clip = os.path.join(root, "tokenizer")
    os.makedirs(clip, exist_ok=True)
    chars = sorted(set(string.ascii_lowercase + string.digits + ",.#'-!?"))
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": len(chars) + i for i, c in enumerate(chars)})
    vocab.update({"<|startoftext|>": 49406, "<|endoftext|>": 49407})
    with open(os.path.join(clip, "vocab.json"), "w") as handle:
        json.dump(vocab, handle)
    with open(os.path.join(clip, "merges.txt"), "w") as handle:
        handle.write("#version: 0.2\n")
    with open(os.path.join(clip, "tokenizer_config.json"), "w") as handle:
        json.dump({"model_max_length": 77, "bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
                   "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>", "do_lower_case": True}, handle)
    t5 = os.path.join(root, "tokenizer_2")
    os.makedirs(t5, exist_ok=True)
    pieces = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0), ("\u2581", -2.0)]
    pieces += [("\u2581" + w, -1.0) for w in sorted({w.lower() for w in words})]
    pieces += [(c, -5.0) for c in chars]
    tokenizer = Tokenizer(models.Unigram(pieces, unk_id=2))
    tokenizer.normalizer = normalizers.Lowercase()
    tokenizer.pre_tokenizer = pre_tokenizers.Metaspace(replacement="\u2581", prepend_scheme="always")
    tokenizer.post_processor = processors.TemplateProcessing(single="$A </s>", special_tokens=[("</s>", 1)])
    tokenizer.save(os.path.join(t5, "tokenizer.json"))
    with open(os.path.join(t5, "tokenizer_config.json"), "w") as handle:
        json.dump({"model_max_length": 512, "eos_token": "</s>", "unk_token": "<unk>", "pad_token": "<pad>",
                   "extra_ids": 0}, handle)


def text_encoders(paths: dict) -> list:
    """Phase 15: CLIP-L and T5-XXL through Flux.encode_text and the text
    cache; returns the encoders (bf16, on the card) for phase 4."""
    import dataclasses

    import numpy as np
    import torch

    from simpletuner_tpu_torch.bench_cache import prompts_for, t5_encoder_flops
    from simpletuner_tpu_torch.caching.text_embeds import TextEmbeddingCache
    from simpletuner_tpu_torch.data.backends.local import LocalDataBackend
    from simpletuner_tpu_torch.inference import config_namespace
    from simpletuner_tpu_torch.models.clip import load_clip_text
    from simpletuner_tpu_torch.models.flux import Flux
    from simpletuner_tpu_torch.models.t5 import T5Config, T5EncoderModel
    from simpletuner_tpu_torch.models.text_encoders import TextEncoder, _TinyTokenizer, init_encoder
    from simpletuner_tpu_torch.models.weight_import import save_safetensors

    dev = torch.device("cuda")
    start = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(15)
    clip = load_clip_text(paths["clip_dir"], dtype=torch.bfloat16, device=dev)
    with torch.device(dev):
        t5_f32 = init_encoder(T5EncoderModel(T5Config.xxl(), torch.float32), gen).eval()
        t5 = T5EncoderModel(T5Config.xxl(), torch.bfloat16).eval()
    t5.load_state_dict(t5_f32.state_dict())
    # T5-XXL at full width and a cut depth (its first T5_FILE_LAYERS blocks; the
    # run's 45 GiB write budget) and both tokenizers join phase 14's Flux dir
    # (phases 17-19 encode with them)
    t5_dir = os.path.join(paths["flux_dir"], "text_encoder_2")
    os.makedirs(t5_dir)
    t0 = time.perf_counter()
    save_safetensors({k: v for k, v in t5.state_dict().items()
                      if not k.startswith("encoder.block.") or int(k.split(".")[2]) < T5_FILE_LAYERS},
                     os.path.join(t5_dir, "model.safetensors"))
    with open(os.path.join(t5_dir, "config.json"), "w") as handle:
        json.dump({**dataclasses.asdict(T5Config.xxl()), "num_layers": T5_FILE_LAYERS,
                   "architectures": ["T5EncoderModel"]}, handle)
    write_tokenizers(paths["flux_dir"], " ".join(prompts_for(TEXT_PROMPTS) + TRAIN_CAPTIONS + [TRAIN_PROMPT]).split())
    t5_write_s = time.perf_counter() - t0
    specs = Flux.TEXT_ENCODER_CONFIGURATION
    encoders = [TextEncoder(specs[0], clip, _TinyTokenizer(specs[0].max_length)),
                TextEncoder(specs[1], t5, _TinyTokenizer(specs[1].max_length))]
    model = Flux(config_namespace({"model_family": "flux", "model_flavour": "dev"}))
    model.attach_text_encoders(encoders)
    prompts = prompts_for(TEXT_PROMPTS)
    model.encode_text(prompts[:2])  # warm-up
    encoded = {}

    def encode_fn(batch):
        out = model.encode_text(batch)
        encoded.update(zip(batch, out))
        return out

    cache = TextEmbeddingCache("phase15", LocalDataBackend("phase15"), os.path.join(paths["work"], "text"),
                               "flux", encode_fn=encode_fn, batch_size=TEXT_PROMPTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache.compute_embeddings_for_prompts(prompts)
    e2e_s = time.perf_counter() - t0
    mismatched = []
    for prompt in prompts:
        back, sent = cache.load(prompt), encoded[prompt]
        if sorted(back) != sorted(sent) or not all(back[k].dtype == sent[k].dtype and np.array_equal(back[k], sent[k])
                                                   for k in sent):
            mismatched.append(prompt)
    payload = encoded[prompts[0]]
    shapes = {k: list(v.shape) for k, v in payload.items()}
    if mismatched or shapes != {"t5_embeds": [512, 4096], "pooled_embeds": [768], "attention_mask": [512]} \
            or not all(np.isfinite(encoded[p]["t5_embeds"]).all() for p in prompts):
        raise RuntimeError(f"text cache: {len(mismatched)} payloads differ after the read-back, shapes {shapes}")

    tokens = encoders[1].tokenize(prompts)
    ids = torch.from_numpy(np.asarray(tokens["input_ids"])).to(dev)
    mask = torch.from_numpy(np.asarray(tokens["attention_mask"])).to(dev)
    clip_tokens = encoders[0].tokenize(prompts)
    clip_ids = torch.from_numpy(np.asarray(clip_tokens["input_ids"])).to(dev)
    clip_mask = torch.from_numpy(np.asarray(clip_tokens["attention_mask"])).to(dev)
    with torch.no_grad():
        bf16_out = t5(ids, mask)["last_hidden_state"].float()
        f32_out = t5_f32(ids, mask)["last_hidden_state"]
        t5_ms = cuda_ms(lambda: t5(ids, mask), 5)
        clip_ms = cuda_ms(lambda: clip(clip_ids, clip_mask), 5)
    err = rel_l2(bf16_out, f32_out)
    valid = mask.bool()
    err_valid = rel_l2(bf16_out[valid], f32_out[valid])
    if not (torch.isfinite(bf16_out).all() and err <= T5_BF16_REL_L2):
        raise RuntimeError(f"T5-XXL bf16 against f32: rel L2 {err} (<= {T5_BF16_REL_L2})")
    n_t5 = sum(p.numel() for p in t5.parameters())
    n_clip = sum(p.numel() for p in clip.parameters())
    flops = t5_encoder_flops(n_t5, specs[1].max_length) + t5_encoder_flops(n_clip, specs[0].max_length)
    device_rate = TEXT_PROMPTS / ((t5_ms + clip_ms) / 1e3)
    phase("15 text encoders", prompts=TEXT_PROMPTS, t5_len=specs[1].max_length, clip_len=specs[0].max_length,
          t5_params=n_t5, clip_params=n_clip, valid_tokens=int(valid.sum()), payload_shapes=shapes,
          readback_bitwise=True, e2e_s=e2e_s, e2e_prompts_per_s=TEXT_PROMPTS / e2e_s,
          e2e_mfu=TEXT_PROMPTS / e2e_s * flops / PEAK_BF16_FLOPS, t5_ms_per_batch=t5_ms, clip_ms_per_batch=clip_ms,
          device_prompts_per_s=device_rate, device_mfu=device_rate * flops / PEAK_BF16_FLOPS,
          t5_bf16_vs_f32_rel_l2=err, t5_bf16_vs_f32_rel_l2_valid_tokens=err_valid, bound=T5_BF16_REL_L2,
          peak_gib=torch.cuda.max_memory_allocated() / 2**30, t5_write_s=t5_write_s,
          seconds=time.perf_counter() - start)
    del t5_f32, f32_out, bf16_out
    torch.cuda.empty_cache()
    return encoders


def vae_cache(paths: dict) -> None:
    """Phase 16: the Flux VAE encoder through VAECache.process_buckets."""
    import numpy as np
    import torch

    from simpletuner_tpu_torch.bench_cache import vae_encoder_flops, write_images
    from simpletuner_tpu_torch.caching.vae_cache import VAECache
    from simpletuner_tpu_torch.data.backends.local import LocalDataBackend
    from simpletuner_tpu_torch.data.buckets import BucketConfig, target_size_for_aspect
    from simpletuner_tpu_torch.data.metadata import MetadataBackend
    from simpletuner_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from simpletuner_tpu_torch.models.vae_import import load_vae_params
    from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
    from simpletuner_tpu_torch.training.trainer import vae_encode_fn

    dev = torch.device("cuda")
    start = time.perf_counter()
    root = os.path.join(paths["work"], "vae_cache")
    data_dir = os.path.join(root, "data")
    sizes = ((1024, 1024), (1152, 896), (896, 1152))
    write_images(data_dir, VAE_IMAGES, sizes=sizes, seed=16)
    cfg = VAEConfig.flux()
    vaes = {}
    for dtype in (torch.bfloat16, torch.float32):
        with torch.device(dev):
            vaes[dtype] = AutoencoderKL(cfg, dtype).eval()
        load_flax_params(vaes[dtype], load_vae_params(vaes[dtype], paths["flux_dir"])["params"])
    backend = LocalDataBackend("phase16", instance_data_dir=data_dir)
    buckets = BucketConfig(resolution=1024, resolution_type="pixel_area", crop=False)
    metadata = MetadataBackend("phase16", backend, buckets, instance_data_dir=data_dir,
                               cache_file=os.path.join(root, "buckets.json"),
                               metadata_file=os.path.join(root, "meta.json"))
    metadata.discover()
    targets = {key: target_size_for_aspect(float(key), buckets) for key in metadata.aspect_ratio_bucket_indices}
    if sorted(targets.values()) != sorted(sizes):
        raise RuntimeError(f"VAE cache: buckets {targets}, expected the sizes {sizes}")
    encode = vae_encode_fn(vaes[torch.bfloat16], dev)
    cache = VAECache("phase16", backend, metadata, os.path.join(root, "cache"), encode_fn=encode,
                     bucket_config=buckets, instance_data_dir=data_dir, batch_size=VAE_BATCH, transfer_dtype="uint8")
    for w, h in targets.values():  # one warm-up batch per bucket shape
        encode(np.zeros((VAE_BATCH, h, w, 3), np.uint8), VAE_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    done = cache.process_buckets()
    e2e_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    if done != VAE_IMAGES:
        raise RuntimeError(f"VAE cache: {done} of {VAE_IMAGES} images cached")
    files = sorted(p for paths_ in metadata.aspect_ratio_bucket_indices.values() for p in paths_)
    shapes = {}
    for path in files:
        latent = cache.load(path)
        w, h = targets[metadata.image_metadata[path]["bucket"]]
        if latent.shape != (h // 8, w // 8, 16) or not np.isfinite(latent).all():
            raise RuntimeError(f"VAE cache: {path} holds latents of shape {latent.shape}")
        shapes[f"{w}x{h}"] = list(latent.shape)
    # bf16 latents against the f32 encoder, two images of the square bucket
    square = [p for p in files if metadata.image_metadata[p]["bucket"] == "1.0"][:2]
    pixels = np.stack([cache._prepare_one(p)[1] for p in square])
    with torch.no_grad():
        ref = vae_encode_fn(vaes[torch.float32], dev)(pixels, len(square))
    got = torch.from_numpy(np.stack([cache.load(p) for p in square])).to(dev)
    err = rel_l2(got, ref)
    if not err <= VAE_BF16_REL_L2:
        raise RuntimeError(f"VAE cache: bf16 latents against the f32 encoder, rel L2 {err} (<= {VAE_BF16_REL_L2})")
    batch = torch.from_numpy(np.random.default_rng(16).integers(0, 256, (VAE_BATCH, 1024, 1024, 3),
                                                               dtype=np.uint8)).to(dev)
    vae = vaes[torch.bfloat16]
    with torch.no_grad():
        device_ms = cuda_ms(lambda: vae.encode(batch.to(torch.float32) / 127.5 - 1.0), 3)
    flops = {f"{w}x{h}": vae_encoder_flops(h, w, cfg) for w, h in sizes}
    mean_flops = sum(flops.values()) / len(flops)
    device_rate = VAE_BATCH / (device_ms / 1e3)
    phase("16 vae cache", images=done, batch=VAE_BATCH, buckets={f"{w}x{h}": len(metadata.aspect_ratio_bucket_indices[k])
          for k, (w, h) in targets.items()}, latent_shapes=shapes, route="process_buckets (PIL decode)",
          e2e_s=e2e_s, e2e_images_per_s=done / e2e_s, e2e_mfu=done / e2e_s * mean_flops / PEAK_BF16_FLOPS,
          device_ms_per_batch_1024=device_ms, device_images_per_s=device_rate,
          device_mfu=device_rate * flops["1024x1024"] / PEAK_BF16_FLOPS,
          encode_tflop_per_image=flops, bf16_vs_f32_rel_l2=err, bound=VAE_BF16_REL_L2, peak_gib=peak,
          seconds=time.perf_counter() - start)
    del vaes, vae, batch
    torch.cuda.empty_cache()


def profile_denoise(denoise, noise, sigma) -> None:
    """Phase 6: one denoise call under torch.profiler, device time by bucket."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        for _ in range(2):
            denoise(noise, sigma)
        torch.cuda.synchronize()
        start = time.perf_counter()
        denoise(noise, sigma)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            denoise(noise, sigma)
            torch.cuda.synchronize()
    # device-side events only: the CPU ops that launched them carry their time too
    kernels = [(e.key, e.count, e.device_time_total / 1e3) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    buckets = {"flash_fwd": 0.0, "gemm": 0.0, "other": 0.0}
    for key, _, ms in kernels:
        if "flash_fwd_kernel" in key:
            buckets["flash_fwd"] += ms
        elif any(tag in key.lower() for tag in ("gemm", "nvjet", "cutlass", "xmma")):
            buckets["gemm"] += ms
        else:
            buckets["other"] += ms
    device_ms = sum(buckets.values())
    if not buckets["flash_fwd"]:
        raise RuntimeError("profile: no flash_fwd kernel time in the traced denoise call")
    top = sorted(kernels, key=lambda k: -k[2])[:8]
    phase("6 profile", wall_ms=wall_ms, device_ms=device_ms, idle_share=1 - device_ms / wall_ms,
          bucket_ms=buckets, top=[{"kernel": key[:100], "calls": n, "ms": ms} for key, n, ms in top])


def render_phases(work: str, encoders, kernels, smi: str) -> None:
    """Phases 4-6: the Flux render, its parity call and its profile, from
    phase 15's encoders."""
    import torch

    from simpletuner_tpu_torch.bench import perturb_adaln
    from simpletuner_tpu_torch.inference import CheckpointInferenceRuntime
    from simpletuner_tpu_torch.ops import set_attention_backend

    prompt = "a lighthouse on a basalt cliff at dusk, volumetric light"
    config_path = os.path.join(work, "config.json")
    with open(config_path, "w") as handle:
        json.dump({
            "model_family": "flux", "model_flavour": "dev", "model_type": "full",
            "allow_untrained_init": True, "mixed_precision": "bf16", "vae_dtype": "bf16",
            "validation_resolution": RESOLUTION, "validation_seed": 42, "seed": 42,
            "validation_guidance_real": 3.5, "flow_schedule_auto_shift": True,
            "flux_attention_masked_training": True,
        }, handle)

    start = time.perf_counter()
    runtime = CheckpointInferenceRuntime(config_path=config_path, output=os.path.join(work, "out"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - start
    runtime.model.attach_text_encoders(encoders)  # phase 15's full-size CLIP-L and T5-XXL
    module, model = runtime.module, runtime.model
    params = sum(p.numel() for p in module.parameters())
    cfg = model.arch
    if (cfg.hidden_size, cfg.depth_double, cfg.depth_single, cfg.num_heads, cfg.head_dim) != (3072, 19, 38, 24, 128):
        raise RuntimeError(f"not the full-width Flux.1-dev config: {cfg}")

    step_times, step_start, finite, vae_s = [], [], [], []

    def before_step(mod, args):
        torch.cuda.synchronize()
        step_start.append(time.perf_counter())

    def after_step(mod, args, out):
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - step_start[-1])

    def decode_checked(z):
        finite.append(bool(torch.isfinite(z).all()))
        start = time.perf_counter()
        image = decode(z)
        torch.cuda.synchronize()
        vae_s.append(time.perf_counter() - start)
        return image

    hooks = [module.register_forward_pre_hook(before_step), module.register_forward_hook(after_step)]
    decode = runtime.vae.decode
    runtime.vae.decode = decode_checked

    torch.cuda.reset_peak_memory_stats()
    for kernel in kernels:
        kernel.launches = 0
    start = time.perf_counter()
    paths = runtime.render(prompt, steps=STEPS)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - start
    launches = {kernel.name: kernel.launches for kernel in kernels}
    if launches["flash_bwd_dq"] or launches["flash_bwd_dkv"]:
        raise RuntimeError(f"the render launched backward kernels: {launches}")
    peak = torch.cuda.max_memory_allocated()
    runtime.vae.decode = decode
    for hook in hooks:
        hook.remove()

    expected = (cfg.depth_double + cfg.depth_single) * STEPS
    if launches["flash_fwd"] != expected:
        raise RuntimeError(f"flash_fwd launched {launches['flash_fwd']} times in the render, expected {expected}")
    if len(paths) != 1 or finite != [True]:
        raise RuntimeError(f"render produced {paths}, finite latents {finite}")
    check_png(paths[0], RESOLUTION, RESOLUTION)
    phase("4 render", params=params, resolution=RESOLUTION, steps=STEPS, init_s=init_s, render_s=render_s,
          s_per_step=sum(step_times[1:]) / (len(step_times) - 1), step_s=step_times,
          vae_decode_s=vae_s[0], peak_gib=peak / 2**30, launches=launches,
          png=os.path.basename(paths[0]), png_bytes=os.path.getsize(paths[0]), device=smi)

    # phase 5: AdaLN lin weights start at zero, so every gate is 0 and
    # attention would not reach the output; give them the lecun-normal
    # draw every other kernel gets
    gen = torch.Generator(device="cuda").manual_seed(5)
    perturb_adaln(module, gen)
    dev = torch.device("cuda")
    latent = RESOLUTION // 8
    batch = {"latents": torch.zeros((1, latent, latent, model.latent_channels), device=dev)}
    embeds = model.encode_text([prompt])[0]
    for key, value in model.collate_text_embeds([embeds]).items():
        batch[key] = torch.as_tensor(value, device=dev)
    cond = model.inference_conditioning(batch)
    noise = torch.randn((1, latent, latent, model.latent_channels), generator=gen, device=dev)
    sigma = torch.tensor(0.7)
    unmasked_cond = {k: v for k, v in cond.items() if k != "t5_masks"}
    with torch.no_grad():
        kernel_v = model.denoise_fn(module, cond)(noise, sigma)
        unmasked_v = model.denoise_fn(module, unmasked_cond)(noise, sigma)
        set_attention_backend("xla")
        try:
            plain_v = model.denoise_fn(module, cond)(noise, sigma)
        finally:
            set_attention_backend("auto")
        step_ms = {}
        for label in ("masked", "unmasked", "unmasked", "masked"):  # in turns
            fn = model.denoise_fn(module, cond if label == "masked" else unmasked_cond)
            step_ms.setdefault(label, []).append(cuda_ms(lambda: fn(noise, sigma), 3, warmup=1))
    err, mask_effect = rel_l2(kernel_v, plain_v), rel_l2(unmasked_v, plain_v)
    if not (torch.isfinite(kernel_v).all() and err <= PARITY_REL_L2 and mask_effect > 5 * err):
        raise RuntimeError(f"full-width parity: rel L2 {err} (<= {PARITY_REL_L2}), mask effect {mask_effect}")
    phase("5 parity", rel_l2=err, bound=PARITY_REL_L2, unmasked_rel_l2=mask_effect,
          denoise_ms_masked=step_ms["masked"], denoise_ms_unmasked=step_ms["unmasked"],
          txt_valid=int(embeds["attention_mask"].sum()))
    profile_denoise(model.denoise_fn(module, unmasked_cond), noise, sigma)  # as the render runs it
    del runtime, module, model
    torch.cuda.empty_cache()


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="Drive the torch port once on one NVIDIA GPU and check it.")
    parser.add_argument("--phases", help="run these phases (e.g. 1-3,14-16,25,26), the phases they need and 1-3, 7")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    phase("1 environment", torch=torch.__version__, cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))
    print(smi, flush=True)

    from simpletuner_tpu_torch import csrc
    from simpletuner_tpu_torch.ops import flash_bwd_dkv_kernel, flash_bwd_dq_kernel, flash_fwd_kernel

    kernels = [flash_fwd_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel]
    libraries = sorted({kernel.library for kernel in kernels})
    start = time.perf_counter()
    csrc.build(libraries)  # one nvcc per source, all at once
    for library in libraries:
        csrc.load(library)
    ptxas = {library: [line.strip() for line in csrc.build_log_path(library).read_text().splitlines()
                       if any(key in line for key in ("entry function", "registers", "spill", "warning"))]
             for library in libraries}
    phase("2 build", seconds=time.perf_counter() - start, nvcc_seconds=csrc.BUILD_SECONDS, ptxas=ptxas)

    if args.phases is not None:
        RUN["requested"] = named_phases(args.phases)
        RUN["phases"] = with_needs(RUN["requested"])
    print(json.dumps({"phases": sorted(RUN["phases"])}), flush=True)

    fwd_entry, fwd256_entry, long_fwd_entries = kernel_cases()
    launches = {"main": None, "auraflow": {}, "wan": {}, "ltx": {}, "chroma": None, "lumina2": {}, "kandinsky5": {},
                "hunyuanvideo": {}, "qwen_image": {}, "hidream": {}, "flux2": {}, "kolors": {}, "longcat_image": {},
                "z_image_omni": {}, "zlab_i1": {}, "krea2": {}, "cosmos": {}, "anima": {}, "omnigen": {}, "ernie": {},
                "ideogram": {}, "longcat_video": {}, "sana": {}, "sanavideo": {}, "cosmos3": {}, "ltxvideo2": {},
                "ace_step": {}, "wan_s2v": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        checkpoints = weight_import(work) if _runs(14) else {"work": work}
        encoders = text_encoders(checkpoints) if _runs(15) else None
        if _runs(16):
            vae_cache(checkpoints)
        if _runs(4):
            render_phases(work, encoders, kernels, smi)
        del encoders
        torch.cuda.empty_cache()

        bwd_entries = backward_cases()
        if _runs(8):
            train_steps(kernels)
        if _runs(9):
            gradient_parity("9 gradient parity")
        if _runs(10):
            int8_cases()
        if _runs(11):
            gradient_parity("11 gradient parity (int8 base)", quant="int8")
        flagship_median = None
        if _runs(12):
            launches["main"], flagship_median = graph_step(kernels)
        if _runs(13):
            gradient_parity("13 gradient parity (full depth)", depth=(19, 38))
        if _runs(17):
            phase17 = trainer_phase(checkpoints, flagship_median, kernels, smi)
            if _runs(18):
                server_phase(phase17, smi)
        from simpletuner_tpu_torch.inference import config_namespace
        from simpletuner_tpu_torch.models.ace_step import ACEStep
        from simpletuner_tpu_torch.models.anima import Anima, AnimaConfig
        from simpletuner_tpu_torch.models.auraflow import AuraFlow, AuraFlowConfig
        from simpletuner_tpu_torch.models.checkpoint_layouts import (
            auraflow_checkpoint_shapes, chroma_checkpoint_shapes, hidream_checkpoint_shapes,
            hunyuanvideo_checkpoint_shapes, kandinsky5_checkpoint_shapes, longcat_image_checkpoint_shapes,
            ltx_checkpoint_shapes, lumina2_checkpoint_shapes, qwen_image_checkpoint_shapes, sd3_checkpoint_shapes,
            unet_checkpoint_shapes, wan_checkpoint_shapes, z_image_omni_checkpoint_shapes,
        )
        from simpletuner_tpu_torch.models.chroma import Chroma, ChromaConfig
        from simpletuner_tpu_torch.models.cosmos2 import Cosmos2Image
        from simpletuner_tpu_torch.models.cosmos3 import Cosmos3
        from simpletuner_tpu_torch.models.ernie import Ernie
        from simpletuner_tpu_torch.models.extended import WanS2V
        from simpletuner_tpu_torch.models.flux2 import Flux2
        from simpletuner_tpu_torch.models.hidream import HiDream, HiDreamConfig
        from simpletuner_tpu_torch.models.hunyuanvideo import HunyuanVideo, HunyuanVideo15Config
        from simpletuner_tpu_torch.models.ideogram import Ideogram
        from simpletuner_tpu_torch.models.kandinsky5 import Kandinsky5Config, Kandinsky5Video
        from simpletuner_tpu_torch.models.kolors import Kolors
        from simpletuner_tpu_torch.models.krea2 import Krea2
        from simpletuner_tpu_torch.models.longcat_image import LongcatImage
        from simpletuner_tpu_torch.models.longcat_video import LongcatVideo
        from simpletuner_tpu_torch.models.ltxvideo import LTXConfig, LTXVideo
        from simpletuner_tpu_torch.models.ltxvideo2 import LTXVideo2
        from simpletuner_tpu_torch.models.lumina2 import Lumina2, Lumina2Config
        from simpletuner_tpu_torch.models.mageflow import ZImage
        from simpletuner_tpu_torch.models.omnigen import OmniGen
        from simpletuner_tpu_torch.models.qwen_image import QwenImage, QwenImageConfig
        from simpletuner_tpu_torch.models.sana import Sana
        from simpletuner_tpu_torch.models.sanavideo import SanaVideo
        from simpletuner_tpu_torch.models.sd3 import SD3, SD3Config
        from simpletuner_tpu_torch.models.sdxl import SDXL
        from simpletuner_tpu_torch.models.wan import Wan, WanConfig
        from simpletuner_tpu_torch.models.z_image_omni import ZImageOmni, ZImageOmniConfig
        from simpletuner_tpu_torch.models.zlab_i1 import ZlabI1Config

        def extra_gb(layout, full, cut) -> float:  # e4m3: one byte a parameter
            return sum(math.prod(v) for v in layout(full).values()) / 1e9 - \
                sum(math.prod(v) for v in layout(cut).values()) / 1e9

        if _runs(19):
            full = SD3Config.large()
            depth = full.depth if _full_depth(19, extra_gb(sd3_checkpoint_shapes, full, dataclasses.replace(
                full, depth=SD3_CUT_BLOCKS))) else SD3_CUT_BLOCKS
            with family_depth(SD3, depth=depth):
                sd3_phase(checkpoints, kernels, smi, depth)
        if _runs(20):
            sdxl = SDXL(config_namespace({"model_family": "sdxl"})).arch
            cut = dataclasses.replace(sdxl, transformer_layers=SDXL_CUT_LAYERS)
            layers = sdxl.transformer_layers if _full_depth(20, extra_gb(unet_checkpoint_shapes, sdxl, cut)) \
                else SDXL_CUT_LAYERS
            with family_depth(SDXL, transformer_layers=layers):
                sdxl_phase(checkpoints, kernels, smi, layers)
        if _runs(21):
            ddpm_families_phase(checkpoints, kernels, smi)
        if _runs(22):
            full = AuraFlowConfig()
            cut = dataclasses.replace(full, depth_double=AURA_CUT_BLOCKS[0], depth_single=AURA_CUT_BLOCKS[1])
            depth = (full.depth_double, full.depth_single) if _full_depth(
                22, extra_gb(auraflow_checkpoint_shapes, full, cut)) else AURA_CUT_BLOCKS
            with family_depth(AuraFlow, depth_double=depth[0], depth_single=depth[1]):
                launches["auraflow"] = auraflow_phase(checkpoints, kernels, smi, depth)
        if _runs(23):
            full = WanConfig.b1_3()
            depth = full.depth if _full_depth(23, extra_gb(wan_checkpoint_shapes, full, dataclasses.replace(
                full, depth=WAN_CUT_BLOCKS))) else WAN_CUT_BLOCKS
            with family_depth(Wan, depth=depth):
                launches["wan"] = wan_phase(checkpoints, kernels, smi, depth)
        if _runs(24):
            full = LTXConfig()
            depth = full.depth if _full_depth(24, extra_gb(ltx_checkpoint_shapes, full, dataclasses.replace(
                full, depth=LTX_CUT_BLOCKS))) else LTX_CUT_BLOCKS
            with family_depth(LTXVideo, depth=depth):
                launches["ltx"] = ltx_phase(checkpoints, kernels, smi, depth)
        if _runs(25):
            full = ChromaConfig()
            cut = dataclasses.replace(full, depth_double=CHROMA_CUT_BLOCKS[0], depth_single=CHROMA_CUT_BLOCKS[1])
            depth = (full.depth_double, full.depth_single) if _full_depth(
                25, extra_gb(chroma_checkpoint_shapes, full, cut)) else CHROMA_CUT_BLOCKS
            with family_depth(Chroma, depth_double=depth[0], depth_single=depth[1]):
                launches["chroma"] = chroma_phase(checkpoints, kernels, smi, depth)
        if _runs(26):
            full = Lumina2Config()
            depth = full.depth if _full_depth(26, extra_gb(lumina2_checkpoint_shapes, full, dataclasses.replace(
                full, depth=LUMINA_CUT_BLOCKS))) else LUMINA_CUT_BLOCKS
            with family_depth(Lumina2, depth=depth):
                launches["lumina2"] = lumina2_phase(checkpoints, kernels, smi, depth)
        if _runs(27):
            full = Kandinsky5Config()
            cut = dataclasses.replace(full, num_visual_blocks=K5_CUT_BLOCKS)
            depth = full.num_visual_blocks if _full_depth(27, extra_gb(kandinsky5_checkpoint_shapes, full, cut)) \
                else K5_CUT_BLOCKS
            with family_depth(Kandinsky5Video, num_visual_blocks=depth):  # the image flavour's class inherits it
                launches["kandinsky5"] = kandinsky5_phase(checkpoints, kernels, smi, depth)
        if _runs(28):
            full = HunyuanVideo15Config()
            depth = full.depth if _full_depth(28, extra_gb(hunyuanvideo_checkpoint_shapes, full, dataclasses.replace(
                full, depth=HY_CUT_BLOCKS))) else HY_CUT_BLOCKS
            with family_depth(HunyuanVideo, depth=depth):
                launches["hunyuanvideo"] = hunyuanvideo_phase(checkpoints, kernels, smi, depth)
        if _runs(29):
            full = QwenImageConfig()
            depth = full.depth if _full_depth(29, extra_gb(qwen_image_checkpoint_shapes, full, dataclasses.replace(
                full, depth=QI_CUT_BLOCKS))) else QI_CUT_BLOCKS
            with family_depth(QwenImage, depth=depth), family_depth(ZImage, depth=ZI_CUT_BLOCKS):
                launches["qwen_image"] = qwen_image_phase(checkpoints, kernels, smi, depth)
        if _runs(30):
            full = HiDreamConfig()
            cut = dataclasses.replace(full, depth_double=HD_CUT_BLOCKS[0], depth_single=HD_CUT_BLOCKS[1])
            depth = (full.depth_double, full.depth_single) if _full_depth(
                30, extra_gb(hidream_checkpoint_shapes, full, cut)) else HD_CUT_BLOCKS
            with family_depth(HiDream, depth_double=depth[0], depth_single=depth[1]):
                launches["hidream"] = hidream_phase(checkpoints, kernels, smi, depth)
        if _runs(31):  # the full depth's bf16 module and e4m3 weights would not fit the card together
            with family_depth(Flux2, depth_double=F2_CUT_BLOCKS[0], depth_single=F2_CUT_BLOCKS[1]):
                launches["flux2"] = flux2_phase(checkpoints, kernels, smi, F2_CUT_BLOCKS)
        if _runs(32):
            kolors = Kolors(config_namespace({"model_family": "kolors"})).arch
            cut = dataclasses.replace(kolors, transformer_layers=KOLORS_CUT_LAYERS)
            layers = kolors.transformer_layers if _full_depth(32, extra_gb(unet_checkpoint_shapes, kolors, cut)) \
                else KOLORS_CUT_LAYERS
            with family_depth(Kolors, transformer_layers=layers):
                launches["kolors"] = kolors_phase(checkpoints, kernels, smi, layers)
        if _runs(33):
            full = LongcatImage(config_namespace({"model_family": "longcat_image"})).arch
            cut = dataclasses.replace(full, depth_double=LC_CUT_BLOCKS[0], depth_single=LC_CUT_BLOCKS[1])
            depth = (full.depth_double, full.depth_single) if _full_depth(
                33, extra_gb(longcat_image_checkpoint_shapes, full, cut)) else LC_CUT_BLOCKS
            with family_depth(LongcatImage, depth_double=depth[0], depth_single=depth[1]):
                launches["longcat_image"] = longcat_image_phase(checkpoints, kernels, smi, depth)
        if _runs(34):
            full = ZImageOmniConfig()
            cut = dataclasses.replace(full, depth=ZO_CUT_BLOCKS[0], refiner_depth=ZO_CUT_BLOCKS[1])
            depth = (full.depth, full.refiner_depth) if _full_depth(
                34, extra_gb(z_image_omni_checkpoint_shapes, full, cut)) else ZO_CUT_BLOCKS
            with family_depth(ZImageOmni, depth=depth[0], refiner_depth=depth[1]):
                launches["z_image_omni"] = z_image_omni_phase(checkpoints, kernels, smi, depth)
        if _runs(35):
            launches["zlab_i1"] = zlab_i1_phase(checkpoints, kernels, smi, ZlabI1Config().depth if 35 in (
                RUN["requested"] or ()) else ZL_MEMORY_BLOCKS)
        if _runs(36):
            with family_depth(Krea2, num_layers=K2_FILE_BLOCKS):
                launches["krea2"] = krea2_phase(checkpoints, kernels, smi, 36 in (RUN["requested"] or ()))
        if _runs(37):
            with family_depth(Cosmos2Image, num_layers=CO_FILE_BLOCKS):
                launches["cosmos"] = cosmos_phase(checkpoints, kernels, smi)
        if _runs(38):
            anima_core = dataclasses.replace(AnimaConfig().core, num_layers=AN_FILE_BLOCKS)
            with family_depth(Anima, core=anima_core):
                launches["anima"] = anima_phase(checkpoints, kernels, smi)
        if _runs(39):
            with family_depth(OmniGen, num_layers=OG_FILE_BLOCKS):
                launches["omnigen"] = omnigen_phase(checkpoints, kernels, smi, 39 in (RUN["requested"] or ()))
        if _runs(40):
            with family_depth(Ernie, num_layers=ER_FILE_BLOCKS):
                launches["ernie"] = ernie_phase(checkpoints, kernels, smi, 40 in (RUN["requested"] or ()))
        if _runs(41):
            with family_depth(Ideogram, num_layers=ID_FILE_BLOCKS):
                launches["ideogram"] = ideogram_phase(checkpoints, kernels, smi, 41 in (RUN["requested"] or ()))
        if _runs(42):
            with family_depth(LongcatVideo, depth=LV_FILE_BLOCKS):
                launches["longcat_video"] = video_dit_phase(42, "longcat_video", checkpoints, kernels, smi,
                                                            42 in (RUN["requested"] or ()))
        if _runs(43):
            with family_depth(Sana, depth=SA_FILE_BLOCKS):
                launches["sana"] = sana_phase(checkpoints, kernels, smi, 43 in (RUN["requested"] or ()))
        if _runs(44):
            with family_depth(SanaVideo, num_layers=SV_FILE_BLOCKS):
                launches["sanavideo"] = video_dit_phase(44, "sanavideo", checkpoints, kernels, smi,
                                                        44 in (RUN["requested"] or ()))
        if _runs(45):
            with family_depth(Cosmos3, num_layers=C3_FILE_LAYERS):
                launches["cosmos3"] = cosmos3_phase(
                    checkpoints, kernels, smi, 45 in (RUN["requested"] or ()),
                    {k: v for k, v in {**long_fwd_entries, **bwd_entries}.items() if k.endswith("c3_gen")})
        if _runs(46):
            with family_depth(LTXVideo2, num_layers=LTX2_FILE_BLOCKS):
                launches["ltxvideo2"] = ltx2_phase(
                    checkpoints, kernels, smi, 46 in (RUN["requested"] or ()),
                    {k: v for k, v in {**long_fwd_entries, **bwd_entries}.items() if "_l2_" in k})
        if _runs(47):
            with family_depth(ACEStep, num_layers=ACE_FILE_BLOCKS):
                launches["ace_step"] = ace_step_phase(
                    checkpoints, kernels, smi, 47 in (RUN["requested"] or ()),
                    {k: v for k, v in {**long_fwd_entries, **bwd_entries}.items() if k.endswith("ace_cross")})
        if _runs(48):
            with family_depth(WanS2V, depth=S2V_FILE_BLOCKS):
                launches["wan_s2v"] = wan_s2v_phase(
                    checkpoints, kernels, smi,
                    {k: v for k, v in {**long_fwd_entries, **bwd_entries}.items() if k.endswith("s2v_cross")})
        else:
            check_run_writes()

    # each wrapper's rows: at the Flux shape (launches: the profiler's count in
    # phase 12's profiled replay), its head dim 256 instances (phase 22's
    # replay, AuraFlow's attention, all at head dim 256), Chroma's (the Flux
    # shape's times; phase 25's replay) and each kernel at Wan's, LTX's,
    # Lumina2's, Kandinsky 5.0's, HunyuanVideo's, Qwen-Image's, Z-Image's,
    # HiDream's, FLUX.2's, Kolors's, LongCat-Image's, Z-Image-Omni's and
    # Zlab-i1's shapes (the wrappers' count at that shape per step in phase
    # 23's, 24's and 26's-35's runs: the trainers', the 14B and 13B steps', the
    # graphed steps of FLUX.2, LongCat's edit flavour and Zlab-i1; per forward
    # for Z-Image-Omni's omni shape); in a run of some phases only, the rows of
    # the phases it ran
    sources = {"flash_fwd": ("csrc/flash_fwd.cu", 68), "flash_bwd_dq": ("csrc/flash_bwd.cu", 197),
               "flash_bwd_dkv": ("csrc/flash_bwd.cu", 239)}
    entries = {"flash_fwd": fwd_entry, "flash_fwd_d256": fwd256_entry, **bwd_entries, **long_fwd_entries}
    main_launches = launches["main"] or {name: None for name in sources}
    rows = [(name, name, name, main_launches) for name in sources]
    if launches["auraflow"]:
        rows += [(f"{name}_d256", f"{name}_d256", name, launches["auraflow"]) for name in sources]
    if launches["chroma"]:
        rows += [(f"{name}_chroma", name, name, launches["chroma"]) for name in sources]
    for family, cases in (("wan", WAN_KERNEL_CASES), ("ltx", LTX_KERNEL_CASES), ("lumina2", LUMINA_KERNEL_CASES),
                          ("kandinsky5", K5_KERNEL_CASES), ("hunyuanvideo", HY_KERNEL_CASES),
                          ("qwen_image", QI_KERNEL_CASES), ("hidream", HD_KERNEL_CASES), ("flux2", F2_KERNEL_CASES),
                          ("kolors", KOLORS_KERNEL_CASES), ("longcat_image", LC_KERNEL_CASES),
                          ("z_image_omni", ZO_KERNEL_CASES), ("zlab_i1", ZL_KERNEL_CASES), ("krea2", K2_KERNEL_CASES),
                          ("cosmos", CO_KERNEL_CASES), ("omnigen", OG_KERNEL_CASES), ("ernie", ER_KERNEL_CASES),
                          ("ideogram", ID_KERNEL_CASES), ("longcat_video", LV_KERNEL_CASES), ("sana", SA_KERNEL_CASES),
                          ("sanavideo", SV_KERNEL_CASES), ("cosmos3", COSMOS3_KERNEL_CASES),
                          ("ltxvideo2", LTX2_KERNEL_CASES), ("ace_step", ACE_KERNEL_CASES),
                          ("wan_s2v", S2V_KERNEL_CASES)):
        if launches[family]:
            rows += [(f"{name}_{case[0]}", f"{name}_{case[0]}", name, launches[family][case[0]])
                     for case in cases for name in sources]
    if launches["anima"]:  # Anima's core: the Cosmos 2B shapes' times, phase 38's launches
        rows += [(f"{name}_anima_{case}", f"{name}_{case}", name, launches["anima"][case])
                 for case in ("co_self", "co_cross") for name in sources]
    # the forward-only shapes (text stage, adapter: no gradient reaches them)
    for family, cases in (("krea2", K2_FUSION_CASES), ("anima", AN_ADAPTER_CASES),
                          ("ltxvideo2", LTX2_CONNECTOR_CASES)):
        if launches[family]:
            rows += [(f"flash_fwd_{case[0]}", f"flash_fwd_{case[0]}", "flash_fwd", launches[family][case[0]])
                     for case in cases]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"simpletuner_tpu_torch/{sources[kernel][0]}",
         "replaces": f"simpletuner_tpu/ops/flash_attention.py:{sources[kernel][1]}", "launches": counts[kernel],
         **entries[entry]}
        for name, entry, kernel, counts in rows
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
