"""Chip smoke test of the PyTorch/CUDA port (callireader_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and continued):
  1. build: compile every CUDA kernel of the port (one nvcc per source, in
     parallel) and the native char-prep library (g++, beside them), and
     print the compiler's version, the card's name and power limit;
  2. main path, callireader-2b: build_engine("callireader-2b",
     device_tile_pages=True: pages tiled on the device) with seeded random
     weights and the committed trained detector / OrderFormer /
     compact CalliAlign tower, then batch_chat_ocr (batch_prepare +
     batch_decode) on synthetic 788x2000 pages. Launch counts are zeroed just
     before and read just after; every attention kernel must have launched,
     the char path must have run, outputs must be finite. Per-stage timings
     and peak memory are printed;
  3. reference: on a small input (2 tiles through the 12-layer tile tower, one
     128-token row through the 8-layer LLM prefill and one decode step), the
     model run through the kernels against the same model with the attention
     swapped for the plain PyTorch versions;
  4. kernels: each attention kernel against its plain version (fp32 math on
     the same bf16 inputs) at the shapes the 2b main path launched it with,
     elementwise within the output's bf16 rounding plus a per-kernel ATOL
     (callireader_tpu_torch/kernels/tolerance.py), flash_decode also 20
     times on the same inputs for the same bits; kernel, plain and one
     PyTorch library call (scaled_dot_product_attention, a yardstick the port
     never calls) timed with CUDA events; the least time the card could take
     (bound) computed from this run's inputs. The 2b engine is then freed;
 22. boot from a reference checkpoint, callireader-2b: the engine drawn with
     no trained assets (seed 0) is written by
     train/checkpoint.export_full_reference_checkpoint (fp32 shards of at
     most 2 GiB, their index, and under params/ the three side files the
     boot reads: the others are not written) into a temporary directory; cli.common.build_engine(checkpoint_dir=...,
     trained_assets=False) boots from it: every leaf bit-equal to the
     in-memory tree (mu and sigma compared in its fp32: the loader casts
     them to bf16, as the JAX loader does), no component drawn at random,
     batch_chat_ocr's token ids on the four pages at 64 tokens equal the
     in-memory engine's, the launches counted on that run (the ViT through
     the tile tower for the char crops too, prefill, decode, RMSNorm
     forward); then ``cli.inference.main(["--tgt", page.npy, "--preset",
     "callireader-2b", "--checkpoint", dir, "--quant", "int8",
     "--no-trained-assets"])`` in-process: its int8 LLM leaves bit-equal to
     the in-memory tree quantized, padded and fused, its token ids equal to
     that tree's engine's through the same CLI, every kernel of the int8 path
     launched. The attention kernels are held against their plain versions
     at the boot run's shapes and flash_decode at the CLI's. The bytes and
     shards, the export and boot seconds and the boot's GB/s are
     printed beside the card's name and power limit; the directory is
     deleted;
  5. main path, flagship: build_engine("callireader-8b", quant="int8",
     device_tile_pages=True) (24-
     layer tile tower, the LLM at the 8b's widths cut to LAYERS_8B of its 32
     layers, int8 weight-only fused projections and a 128-padded int8
     vocab; phases 5-13, 20-21 and 29 run this engine) and batch_chat_ocr on
     the same pages with 256 new tokens. All counts zeroed before, read
     after: every kernel must have launched, the (K, N) int8 kernel 4 x L
     times per decode step (L the LLM's layers) and
     the LM-head kernel once per step plus once in prefill; token ids below
     the real vocabulary. Spans, prefill time, time per decode step against
     the step's weight bytes, and peak memory are printed. The decode ran as
     CUDA graphs (runtime/decode_graph.py); its token ids must equal the same
     chunks run uncaptured (``eager=True``), and so must a sampled decode's
     (a seeded generator, three chunks and a tail graph). Then host against
     device ms and the device's idle share of a decode step, its chunks
     replayed as graphs and run uncaptured, in turns, and of the host-stepped
     ``decode_step`` with the RMSNorm kernel and with the plain norm, in
     turns, then with the RoPE + KV-write kernel (kernels/rope_kv.py) and
     with its plain form (the sixteen eager ops a layer it replaced), in
     turns. Every main path launches the RoPE + KV-write kernel L times a
     decode step;
  6. reference: one 128-token row, prefill plus one decode step through the
     kernels against the same 8b model with every kernel swapped for its
     plain version;
  7. attention kernels as in phase 4, at the shapes the 8b main path
     launched them with (its L-layer cache, the deepest layer), and the
     RoPE + KV-write kernel against its plain form, q and both caches bit
     for bit, at the rows and positions of the path's last decode step
     (so at every path that calls attention_rows: 2b, boot, 8b and the
     serve paths of phase 13);
  8. int8 kernels: each against its plain version at the five main-path
     shapes (wqkv, wo, w13, w2 of the last layer; the LM head), timed with
     the weights cold in L2 (the (K, N) kernel walks the layers), beside
     the yardstick (bf16 torch.matmul against a dequantized bf16 copy of the
     weight, which the port never calls); the fused wqkv / w13 products,
     split, must equal the separate products bit for bit, and each row of
     an LM-head or w13 launch the same row launched alone;
  9. serve, paged: on the same 8b int8 engine, 8 request rows built from
     synthetic pages the way cli/serve.py prepares a wave (batch_calli_align,
     host load_image, encode_image_tiles, _build_row_embeds) go through a
     PagedBatcher(num_slots=8, page_size=128, max_pages_per_slot=32,
     num_pages=257: the CLI's sizes for --slots 8 --max-len 4096) with 256 new
     tokens, once with steps_per_sync=1 and once with 8. Counts zeroed before,
     read after: the paged kernel launched L times per decode step and
     flash_decode not at all; every request finished with token ids below the
     real vocabulary; every page returned; the ticks, CUDA graphs, give the
     token ids, decode steps and launches of the same ticks run uncaptured.
     Admissions, prefill seconds, ms per decode step, tokens per second and
     peak memory are printed, then host against device ms a step and the
     device's idle share from a profiler trace, for both settings, graphed
     and uncaptured;
 10. serve, pressure: the same rows against a pool too small for them: at
     least one preemption, every request completes or fails with its own
     error, every page returns;
 11. serve, HTTP: serve_http on a loopback port over a paged batcher: /health,
     one text-only /v1/chat/completions over a real socket, two page images
     through SchedulerLoop.submit; then a short ContinuousBatcher run (the
     contiguous scheduler's decode goes through flash_decode). Both with the
     counts zeroed before and read after, and their shapes logged; the
     contiguous ticks at steps_per_sync 1 and 8, graphed, give the token ids
     and launches of the same ticks run uncaptured;
 12. reference: three page rows into a batcher of the serve sizes, one
     step() (admission prefill + the first paged decode step) through the
     kernels against the same model with every kernel swapped for its plain
     version (the plain decode step starts from the kernels' admission, so
     both decode the same tokens over the same pools);
 13. kernels of the serving paths: for the paged serve run, the HTTP run and
     the ContinuousBatcher run, every kernel that run launched against its
     plain version at that run's shapes (the 88-tile ViT batch, the 8-row
     prefill, the int8 products at M=8 / 2 / 1, flash_decode at B=2 S=512,
     the paged kernel with the page table and validity of the run's last
     decode step beside the yardstick: gather of the slots' pages +
     scaled_dot_product_attention, which the port never calls), each entry
     carrying that run's launch counts;
 20. bench, short run (after phase 13, on the same engine): the port's
     bench row code (callireader_tpu_torch/bench.py: its detector rule and
     measure()) with 8 pages a batch: the warm-up batch, 2 TTFT samples, one
     warm and 3 steady pipelined intervals, 256 tokens a batch, each batch's
     decode enqueued by batch_prepare behind the next batch's front half
     (its device wait printed). Counts zeroed before,
     read after: every kernel of the 8b path launched, flash_decode and the
     int8 kernels once a layer and step; every batch decodes 256 tokens; the
     phased box stages give batch_sort_boxes' boxes; the row's JSON and the
     combined line are under 2000 characters; flash_decode is held against
     its plain version at the bench's batch of 8;
 21. W8A8 (``--quant int8-all``): the tile tower quantized by
     quantize_vit_int8 on one page's tiles, and the shared char tower at the
     448 canvas on the page's crops (the engine's raw-crop route), against
     the bf16 towers: features within W8A8_REL_TOL relative L2; the int32
     sums of the first layer's four products (torch._int_mm) equal an exact
     fp64 product over W8A8_EXACT_ROWS rows; the ViT kernel against its
     plain version at the char tower's shape;
 29. parallel (after phase 21, on the 8b int8 engine's weights in the
     mesh's unfused layout): (a) the ``--mesh tensor=1`` route in a world of
     1 under NCCL (parallel/spmd.py): one page x MESH_NEW_TOKENS through
     batch_prepare equal, token for token, to the same weights without a
     mesh, its decode graphs replaying with at least one tensor all_reduce
     made inside their captures, every kernel launched as often as without
     the mesh; (b) the prefill, decode,
     paged decode and int8 kernels at the shard shapes of tensor = 2, 4, 8
     at the 8b's widths (parallel/tp_attention.py; column, row and
     vocab-parallel products): rank 0's block timed against its plain
     version, rank t-1's held to it, the blocks joined against the whole
     plain version and the whole kernel, the row-parallel partial sums
     added against the whole product. Rows off the single-card path, 0
     launches;
 14. train, e-IT, callireader-2b bf16 (TRAIN_PRESET: the 8b's widths, so the
     training kernels run at the 8b's shapes, at 12 ViT / 8 LLM layers):
     four synthetic pages become e-IT data the way a user prepares it
     (uint8 .npy pages, pseudo embeddings from the 8b int8 engine's
     batch_calli_align as .npy, a JSONL of question and text), the int8
     engine is freed, then ``cli.train.main([... "--preset",
     "callireader-2b", "--random-init", "--config", "e_it", "--max-iters",
     "2", "--eval-chat-interval", "1"])`` runs in-process: LoRA r128 on all
     seven projections, batch 2 x accumulation 2, remat on, so 4
     micro-steps, and an eval chat (32 new tokens, text only) after each of
     the two updates, on the live adapters. Counts zeroed before, read
     after: the training forward, dq and dk/dv kernels 2L / L / L times a
     micro-step (16 / 8 / 8), the ViT kernel once a ViT layer (12); every
     loss finite; every layer of every LoRA b leaf moved; frozen leaves
     unchanged bit for bit; the final checkpoint restores to the live state;
     the CLI's closing export to the reference layout
     (<out>/export_official, fp32), read back with the port's reader: the
     vocab tables, the final norm and every leaf of the first and last
     layers equal merge_lora(merge_params(final state)) bit for bit.
     ms per micro-step (the first apart), throughput, peak memory, and host
     against device ms of a micro-step from a profiler trace. Each eval chat
     is counted apart (zeroed before, read after, the training run's counts
     put back): the prefill, flash_decode L times a decode step and the
     RMSNorm forward launched and nothing else, a string answer of token ids
     below the real vocabulary; the second chat replays the first chat's
     decode graphs on the adapters the optimizer moved in place, and its
     token ids equal the same chat run uncaptured;
 15. reference: on two batches of 2 rows of at most 512 tokens, one
     micro-step through the trained model, through the kernels
     against the same model with the three training kernels swapped for
     their plain versions; loss and the LoRA / projector grads (relative L2
     per leaf group), beside two witnesses of the comparison's bf16 noise:
     the same step through scaled_dot_product_attention (a yardstick the port
     never calls), and the plain step with every attention output and
     gradient moved one bf16 ulp. Each group's error must stay within twice
     the smaller witness and under REF_GRAD_CAP;
 16. kernels of the training path: the forward, dq and dk/dv kernels against
     their plain versions at the shape and segment ids phase 14 launched
     them with and at the recipe's ceiling B=1, S=8192, beside
     scaled_dot_product_attention and its autograd backward; each row's
     device ms is printed beside its bound;
 24. post-training at full width, on phase 14's LLM and final adapters:
     one step each of (a) SFT: a synthetic JSONL corpus (documents of
     153-1462 tokens of TRAIN_TEXT) packed by sft_data.PackedTextDataset
     into 2048-token rows (3-4 documents a row, positions restarting at
     each), packed_loader's batch of 2 through e_it.make_train_step;
     (b) DPO from fresh adapters (b = 0, as a DPO run starts: its loss is
     log 2 within 1e-6, the policy being the reference) and (c) ORPO on
     phase 14's: dpo.make_dpo_train_step on preference_collate of 2 pairs
     (4 rows in the 2048 bucket); (d) the reward model:
     reward.make_reward_train_step with a value head, at
     long_context_config(2 x max_position_embeddings) (linear RoPE, factor
     2). Counts zeroed before each step, read after: the training forward
     2L a step (the forward and its remat recompute; DPO 3L: and the
     reference's forward, under no_grad), dq and dk/dv L, the RMSNorm
     forward 4L+1 (DPO 6L+2) and backward 2L (the first layer's attention
     norm reads the frozen embedding rows, which need no gradient; e-IT's
     splice of the trainable projector's rows needs 2L+1), nothing else.
     Each loss finite; its ms, peak memory and the kernels' device ms
     printed; each step's loss and LoRA grads held as phase 15 holds the
     e-IT micro-step, against the same step on the plain versions of the
     training and RMSNorm kernels beside that step's own two noise
     witnesses: the loss within 1e-3 relative, each grad group within twice
     the smaller witness and under REF_GRAD_CAP (a group whose plain grads
     are zero, the fresh adapters' a leaves, must be zero). The three
     training kernels are held against
     their plain versions at the SFT step's shape and packed segment ids and
     at the DPO step's;
 17. inference CLI, int8 with an adapter: ``cli.inference.main(["--tgt",
     page.npy, "--preset", "callireader-2b", "--random-init", "--quant",
     "int8", "--adapter", <phase 14's final checkpoint>])`` in-process at
     the CLI's defaults (1024 new tokens), then in folder mode on two .npy
     pages (on the engine the first call built). Counts zeroed before, read
     after each: the tile tower, the char tower, prefill, flash_decode, the
     int8 kernels and the RMSNorm forward launched, token ids below the real
     vocabulary, 2 records in results/recognition.json; one merged bf16 leaf
     equals base + scale * a @ b of the checkpoint before it is quantized.
     Spans, prefill seconds, ms per decode step and peak memory are printed;
     the int8 kernels against their plain versions at the CLI's one row
     (M = 1), every launch of the run at that shape;
 18. beams and chat on that engine: chat_ocr with num_beams=4 (flash_decode
     at B=4, L launches a step, the best beam within 128 tokens), chat
     without CalliAlign and cli.chat's stream_generate for 64 tokens;
     flash_decode is held against its plain version, as in phase 4, at the
     CLI page's shape (batch 1 over its 4,608 slots) and the beams' shape;
     then the agent: ``cli.chat.main(["--agent", "--preset",
     "callireader-2b", "--random-init", "--quant", "int8",
     "--max-new-tokens", "64"])`` in-process with a scripted stdin (an
     arithmetic question, then EXIT) on this engine in place of the CLI's
     own build: at least one stream_generate turn stopping at "Response:",
     a string answer printed; the prefill, flash_decode, both int8 kernels
     and the RMSNorm forward launched; flash_decode held against its plain
     version at the agent's shape;
 23. evaluate, the CalliBench harness (evalx, cli.evaluate) on
     callireader-2b int8 at full width: ``cli.evaluate.main(["--type",
     "full_page", "--splits", "easy", "--preset", "callireader-2b",
     "--random-init", "--quant", "int8", ...])`` in-process at the
     harness's defaults (RGB char crops resized on the host by the native
     char-prep library, host tiling, batch 8, 1024 new tokens, repetition
     penalty 1.0), its parquet reader swapped for in-memory synthetic tasks
     (EVAL_PAGES of the seeded 788x2000 pages with ground-truth strings: two
     pipelined batches, batch i built while decode i-1 runs; the pages' host
     tiles are made ahead in two worker processes during phases 24 and
     17-18, so the run reads them). Counts zeroed before the full_page run,
     read after: the tile and char towers, prefill, flash_decode, both int8
     kernels and the RMSNorm forward launched, once a layer and step; every
     char crop took the host route as an RGB (n, c, c, 3) stack, no raw
     device group was built; the pipelined responses equal batch_chat_ocr
     on the same 8 pages. On the engine the CLI built: region_wise on
     EVAL_REGIONS regions, choice, bilingual and intent on EVAL_TWO_TURN
     788x896 works each (the top of a page; two turns, the second over the
     first's history), mmbench
     on EVAL_MMBENCH rows (16 tokens) and refcoco on EVAL_REFCOCO samples.
     Every result file has the JAX layout and sample counts, every response
     is a string. The ViT kernel is held against its plain version at the
     full_page run's tile and char tower batches (the char tower on the RGB
     host canvases), the prefill kernel at the choice task's longest
     (second-turn) prompt, flash_decode at that task's batch. Printed: seconds per task, full_page pages/s pipelined
     and batch_chat_ocr's, and the share of VQ indices on which the RGB host
     route agrees with the default luma device route on one page's crops;
 25. char prep: the native library (csrc/charprep.cpp, built with g++ in
     phase 1) over the full_page run's raw char crops, against the plain
     numpy route: within 3/255 a pixel, both white outside the content's place,
     the same bytes at 1 and 8 threads, its resize within 2/255; ms a crop
     on both routes, and phase 23's char_prep seconds;
 26. library models: models/moe.forward at the default MoEConfig widths
     (E=4096, M=14336, 8 experts, top-2, 32/8 heads of 128, vocab 92553)
     cut to 4 layers, B=2 S=2048 with two segments a row, counted and held
     against its all-plain route (tokens whose top-2 experts flip counted,
     the rest's logits and the aux loss within 5e-2 rel); then
     models/llava.llava_loss on the 2b's widths (B=2, 256 text tokens +
     1024 patches), counted, its loss and projector / LLM grads held as
     phase 24 holds a step; ms, device ms and peak memory; the prefill, ViT,
     training attention and RMSNorm kernels at these shapes (phase 19 takes
     the norms);
 27. trainers: train_orderformer on 512 synthetic layouts (2 epochs, batch
     64) and 10 detector steps at 640 (batch 8, synth_calligraphy_pages):
     each loss falls; ms a step; save_npz -> load_npz bit for bit at fp16,
     the loaded tree in the port's Detector; each script's main once with
     tiny arguments;
 28. callialign: train/callialign_train.py and its script. v3 at the
     shipping widths (a 6-layer 256-wide ViT at 224, the 92553 x 4096 fp32
     table) on a glyph-only pool: the first step at batch 8 against the same
     step on the CPU (loss and grads), then 40 steps of the script's
     train_loop at batch 96 (the loss falls; ms a step, peak memory); the
     asset it saves through apply_v3_asset into the engine's char route
     (the ViT kernel at D=32, 6 launches), held against v3_forward in bf16
     with the plain attention, and the kernel row at that shape; v2 at the
     8b's tile tower (24 layers at 448, the default resampler): 3 steps
     under remat at batch 8 (finite, the LoRA B factors move), the grads
     with and without remat at batch 2;
 30. the measurement scripts (callireader_tpu_torch/scripts/, the JAX
     repository's scripts/ ported), each ``main(argv)`` in process at
     SCRIPTS_PRESET with short counts, counts zeroed before each and read
     after; each JSON line parses, carries the JAX script's keys (read from
     scripts/<name>.py with ast) with the port's changes (``device`` = the
     card's name and power limit, ``platform``, the H100's roofline key)
     and finite, positive numbers, and every kernel of the script's path
     launched, as often as its layers and steps make: bench_decode
     (flash_decode L times a decode step; its row at that shape),
     bench_serving (contiguous bf16, then paged int8 at steps_per_sync 8:
     every request at its staggered length), bench_http (every request
     answers 200), bench_prefix (the chunked prefill's last logits within
     MODEL_REL_TOL of the full prefill's; the prefill kernel's rows at its
     shapes, q_offset among them), bench_train_step, bench_vit --attn-impl
     both (the kernel's encode within MODEL_REL_TOL of the plain one's),
     bench_8b_int8 at the 8b's widths with LAYERS_8B layers on host draws
     made ahead in a worker process during phases 14-28 (it fits the card),
     mb_scan_int8 at MB_SCAN_L layers (stacked, unrolled and graph give the
     same bits; the (K, N) kernel's row at its shape);
 31. the MLA-MoE LLM (moonlight_phase): moonlight-16b-a3b at its published
     widths with its LLM cut to MOON_LAYERS layers, 4 pages through the box
     stage and batch_build_rows, MOON_TOKENS tokens decoded as CUDA graphs
     and uncaptured (the same ids); the latent prefill, grouped expert and
     latent decode kernels' launches on the route required; each held to
     its plain version at the route's shapes;
 19. the RMSNorm kernels against their plain versions at every path's shapes
     (E = 4096; 8b batch, serve, 2b CLI, beams: decode and prefill rows; train:
     2 x 2048 rows, forward and backward with dw on and off), both roundings:
     the one-rounding form (rms_norm_pallas's) within kernels/tolerance.py's
     rule, the model's two-rounding form within one bf16 ulp elementwise and
     few elements apart; the backward's bits equal in two runs; beside
     torch.nn.functional.rms_norm (a yardstick the port never calls). The
     backward is timed on its whole route (``_bwd``) and held to one kernel
     launch a call (torch.profiler's kernels), dw (E,) read from that launch
     within 1e-5 of the sum of its terms' sizes, dx within one bf16 ulp of
     the row-group kernel it replaced (tests/data/rmsnorm_bwd_rows.cu, built
     in phase 1), whose route (plus torch.sum of its dw partials) is timed
     beside it as the row's "was".
Decode steps are counted by the model's ``DECODE_STEPS`` and launches by the
kernels' counts, both kept true under graph replays (a capture's launches are
taken off and added back at each replay), and the shape log records a
graph's captured launches again at each of its replays.
Every phase that drives a path asserts the RMSNorm counts: the model forward
2L+1 times per prefill and per decode step (2b, 8b, serve, pressure, HTTP,
contiguous, CLI, beams, chat, stream, eval chat, agent); in a training
micro-step under remat 4L+1 forward and 2L+1 backward (no dw: the norm
weights are frozen). Phase 19 takes the eval chat's and the agent's shapes
too. Phases 3, 6, 12 and
15 swap the RMSNorm kernels for their plain versions as well.
Each ``kernels`` entry carries the device ms a call (torch.profiler) and its
ratio to the bound. The build log names each kernel beside its registers and
spills (``-Xptxas -v``); phase 8 and 13 hold each row of the LM head's
launch, and of the (K, N) kernel's at the w13 projection, to the same row
launched alone, bit for bit, and the log compares the int8 kernels' and the
paged kernel's device ms with their bounds across the paths' row counts.
Phases run in the order 1-4, 22, 5-13, 20-21, 29, 14-16, 24, 17-18, 23, 25-28, 30, 19.
Prints the wall seconds of each phase, the card's name and power limit, the
``kernels`` JSON line (it fails if a kernel has no entry), then the last line
``{"ok": true, "device": {...}}``. Exits non-zero without CUDA or without the
port's sources next to it.
"""

import contextlib
import dataclasses
import functools
import gc
import hashlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request

import numpy as np

N_PAGES = 4
MAX_NEW_TOKENS = 64
MAX_NEW_TOKENS_8B = 256
# phases 5-13, 20-21 and 29 and phase 30's bench_8b_int8 run the 8b's widths
# with its LLM cut from 32 to this many layers (card time: the script and the
# card tests keep inside 600 s; 16 until phase 30 came)
LAYERS_8B = 8
SERVE_SLOTS, SERVE_PAGE, SERVE_PAGES_PER_SLOT = 8, 128, 32  # serve --slots 8 --max-len 4096
SERVE_NEW_TOKENS = 256
PRESSURE_FREE_PAGES, PRESSURE_NEW_TOKENS = 118, 160
QUESTION = "读出图中所有文字。"
# e-IT answers: the pages' "text", drawn from the Thousand Character Classic
TRAIN_TEXT = ("天地玄黄宇宙洪荒日月盈昃辰宿列张寒来暑往秋收冬藏闰余成岁律吕调阳云腾致雨露结为霜金生丽水玉出昆冈"
              "剑号巨阙珠称夜光果珍李柰菜重芥姜海咸河淡鳞潜羽翔龙师火帝鸟官人皇始制文字乃服衣裳推位让国有虞陶唐")
TRAIN_CEILING = 8192  # the recipe's max_length
# phase 24: post-training at full width on phase 14's LLM and adapters. The
# SFT corpus: documents of these many characters of TRAIN_TEXT (153-1462
# tokens), packed into rows of POST_PACKED tokens as the zoo's standard 2k
# recipes pack them (3-4 documents a row). The preference pairs of the DPO,
# ORPO and reward steps: characters of prompt, chosen and rejected (the
# longest row falls in the 2048 bucket)
POST_SFT_DOCS = (150, 1400, 700, 333, 1200, 480, 900, 620, 1000, 275, 800, 555)
POST_PACKED = 2048
POST_PAIRS = ((60, 1700, 1200), (40, 900, 1500))
# phase 14's eval chats and phase 18's agent: new tokens a turn
EVAL_CHAT_TOKENS, AGENT_TOKENS = 32, 64
AGENT_STDIN = "12乘以34等于多少？\nEXIT\n"
# phase 15: the largest grads rel L2 error a leaf group may show. On an H100
# the library witness reads at most 6.46e-2 in any group of either batch (the
# +-1 ulp witness 8.42e-2, the kernels 5.92e-2): an error above what the
# library itself shows is not noise
REF_GRAD_CAP = 7e-2
TRAIN_FROZEN = (("llm", "layers", "wq"), ("llm", "layers", "w2"), ("llm", "layers", "attn_norm"),
                ("llm", "output"), ("vision", "layers", "fc1_kernel"))
# phase 5: the sampled decode held graph against eager (3 chunks and a tail of 4)
# phase 29: the --mesh route's page (a world of 1), new tokens
MESH_NEW_TOKENS = 32
SAMPLED_TOKENS = 28
# phase 11: the contiguous server's ticks held graph against eager
CONT_NEW_TOKENS = 24
# phase 20: the bench's short run, batches of intervals (3 steady ones)
BENCH_SHORT_BATCHES = 4
# phase 21: W8A8 towers against the bf16 towers (features rel L2), and the
# rows of each int32 product held to an exact fp64 product
W8A8_REL_TOL = 5e-2
W8A8_EXACT_ROWS = 512
# phases 14-18: e-IT training and the CLI on its adapter run at the 2b's
# depth (the 8b's widths: the training kernels' shapes are the 8b's)
TRAIN_PRESET = "callireader-2b"
# phase 22: the boot from a reference checkpoint (the preset's export in
# shards of at most 2 GiB)
BOOT_PRESET, BOOT_SHARD = "callireader-2b", 2 << 30
BOOT_SIDE_READ = ("gauss_norm_mu_sigma.pth", "orderformer.pth", "best.pt")
# phase 23: the evaluation harness's synthetic CalliBench (in memory, under
# this parquet root), its pages and samples a task
EVAL_DATA = "CalliBench"
EVAL_PAGES = 16  # full_page: two pipelined batches of 8
EVAL_REGIONS = 8
EVAL_REGION = ((0, 500), (788, 1300))  # [[x1, y1], [x2, y2]] of a page
EVAL_TWO_TURN = 3  # choice, bilingual and intent samples each
EVAL_WORK_ROWS = 896  # their works: the top of a page, 788x896 (6 columns, 42 chars)
EVAL_MMBENCH = 8
EVAL_REFCOCO = 2
NORM_KERNELS = ("rms_norm_fwd", "rms_norm_bwd", "rms_norm_fwd_fused", "rms_norm_bwd_fused")
# phase 25: the native char-prep library against the plain numpy route over
# phase 23's crops, within tests/test_native_prep.py's bounds (per pixel, of
# 255); the resize on this many of them
CHARPREP_TOL, RESIZE_TOL, RESIZE_CROPS = 3, 2, 64
# phase 26: MoE at the default MoEConfig widths with its depth cut to 4
# layers (2.82 GB of bf16 experts a layer: 32 would not fit the card), B=2
# S=2048, each row two segments split here; LLaVA at the 2b's widths, B=2,
# 256 text tokens and a 448 px image (1024 patches), the placeholders here
MOE_LAYERS, MOE_B, MOE_S, MOE_SPLITS = 4, 2, 2048, (1200, 900)
# phase 31: the MLA-MoE LLM (moonlight-16b-a3b) on the page route, its depth
# cut to the dense layer and 3 expert layers (the whole model is the
# benchmark cell's), 4 pages, new tokens
MOON_LAYERS, MOON_TOKENS = 4, 64
MODEL_REL_TOL = 5e-2  # the model bound of PERF.md section 2
LLAVA_TEXT, LLAVA_IMAGE_AT, LLAVA_PROMPT = 256, (5, 100), 8
# phase 27: the asset trainers
OF_LAYOUTS, OF_EPOCHS, OF_BATCH, OF_LR = 512, 2, 64, 1e-3
DET_STEPS, DET_BATCH, DET_SIZE, DET_GLYPHS = 10, 8, 640, 64
# phase 28: CalliAlign. v3 (the shipping widths, float32) on a glyph-only
# pool: distractor classes capped for the glyphs' host time, views a class,
# steps and batch of the script's loop; its first step at CA_CPU_BATCH held
# against the same step on the CPU (float32 both, TF32 off: the loss within
# CA_CPU_LOSS_REL, the grads within CA_CPU_GRAD_REL rel L2; on an H100 the
# step reads 0 and 7.2e-5, its witness with TF32 on 2.5e-4 and 6.3e-2); the
# readout of CA_READOUT training crops through the engine's
# char route against v3_forward in bf16 with the plain attention (rel L2 of
# the normalised pseudo tokens within MODEL_REL_TOL); v2 at the 8b's tile tower: CA_V2_STEPS
# steps at batch CA_V2_BATCH, LoRA rank CA_V2_RANK, then the grads with and
# without remat at batch 2 (the recomputation runs the same kernels)
CA_SYNTH_CHARS, CA_SYNTH_VIEWS, CA_STEPS, CA_BATCH = 256, 4, 40, 96
CA_CPU_BATCH, CA_CPU_LOSS_REL, CA_CPU_GRAD_REL = 8, 1e-5, 1e-3
CA_READOUT = 64
CA_V2_STEPS, CA_V2_BATCH, CA_V2_RANK, CA_V2_LR, CA_REMAT_REL = 3, 8, 16, 1e-3, 1e-4
# phase 30: the measurement scripts at this preset (the 8b's widths, its
# depth cut: 8 LLM layers), mb_scan_int8 over this many stacked layers
SCRIPTS_PRESET, MB_SCAN_L = "callireader-2b", 16
# H100 SXM: 3.35 TB/s HBM, 989 TFLOP/s dense bf16 tensor cores (data sheet)
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12


def make_page(seed: int = 0):
    """The bench's synthetic calligraphy page (callireader_tpu_torch/bench.py:
    6 columns of 16 dark glyph blocks on noisy paper) -> (page, boxes);
    imported here so that the script alone, without the port, still starts
    and fails with its message."""
    from callireader_tpu_torch.bench import make_page as bench_page

    return bench_page(seed)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


START = time.time()


def log(msg: str) -> None:
    """A line of the run's log, stamped with the seconds since the start."""
    print(f"[chip_smoke {time.time() - START:6.1f}s] {msg}", flush=True)


def time_ms(fn, torch, min_total_ms: float = 50.0, max_iters: int = 50) -> float:
    """Mean time per launch over a run of launches between two CUDA events,
    after one warm-up launch (the run is sized to ~min_total_ms)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    one = max(start.elapsed_time(end), 1e-3)
    iters = int(min(max_iters, max(3, min_total_ms / one)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(fn, torch, n: int):
    """Kernels on the device while ``fn`` runs ``n`` times under
    torch.profiler -> ({kernel name: (total device us, launches)}, the
    device's idle share in the trace), ({}, None) if the trace holds no
    device events. The idle share is read from the trace alone: 1 - the time
    some kernel ran over the span from the first kernel's start to the last
    one's end (the profiler's own host cost included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, k = out.get(e.name, (0.0, 0))
            out[e.name] = (us + e.time_range.elapsed_us(), k + 1)
            spans.append((e.time_range.start, e.time_range.end))
    if not spans:
        return out, None
    spans.sort()
    busy, end = 0, spans[0][0]
    for s, e in spans:  # the union of the kernels' intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    return out, 1 - busy / max(end - spans[0][0], 1e-9)


def device_ms(fn, torch, n: int = 16, tries: int = 3):
    """Device time per call from a profiler trace of ``n`` calls -> (ms,
    calls the trace holds), or (None, 0) if it has no device events: for each
    kernel the mean duration of its events times its launches per call. The
    trace of a process that has launched many kernels lacks the events of some
    calls at one edge (seen: 1 to 12 of 16, and all 16 of the long training
    kernels late in the script), so a kernel's launches per call are counted
    against the kernel with the fewest events (every call launches each of its
    kernels at least once), not against ``n``; a trace that holds fewer than
    half the calls is taken again, up to ``tries`` times, and the fullest kept."""
    best = (None, 0)
    for _ in range(tries):
        kern = device_kernels(fn, torch, n)[0]
        if kern:
            calls = min(c for _, c in kern.values())
            if calls > best[1]:
                best = (sum(us / c * round(c / calls) for us, c in kern.values()) / 1e3, calls)
        if best[1] >= n // 2:
            break
    return best


def profiled(fn, torch):
    """``fn()`` once under torch.profiler -> (its result, {kernel name:
    (total device us, launches)})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kern = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, k = kern.get(e.name, (0.0, 0))
            kern[e.name] = (us + e.time_range.elapsed_us(), k + 1)
    return out, kern


class ShapeLog:
    """Records, per kernel wrapper, a light summary of each launch's inputs on
    the main path (the script wraps the wrappers' launch functions while a log
    is open; the port is unchanged): shapes, plus the small mask tensors the
    kernel is held to. A launch made while a CUDA graph is captured did not
    run: its summary is kept with the graph (runtime/decode_graph.StepGraph,
    ``install``) and recorded again at each replay, as the launch counts are;
    its masks are kept by reference (the graph rewrites them at each replay),
    a launch's are cloned."""

    SUMMARY = {
        "vit_attention": lambda a, keep: (tuple(a[0].shape), a[1]),
        "flash_attention": lambda a, keep: (tuple(a[0].shape), tuple(a[1].shape), a[3],
                                            keep(a[4]), keep(a[5]), a[7]),
        "flash_decode": lambda a, keep: (tuple(a[0].shape), tuple(a[1].shape), a[3], keep(a[4])),
        "int8_matmul": lambda a, keep: (a[0].shape[0], *a[1].shape),  # (M, K, N)
        "int8_matmul_nt": lambda a, keep: (a[0].shape[0], a[1].shape[1], a[1].shape[0]),
        # (q, kpool, vpool, layer, page_table, valid, scale): the table and the
        # validity of the deepest layer's call only (one clone a decode step)
        "paged_flash_decode": lambda a, keep: (
            (tuple(a[0].shape), tuple(a[1].shape), a[3], keep(a[4]), keep(a[5]))
            if a[3] == a[1].shape[0] - 1 else None),
        # (q, k, v, q_seg, kv_seg, causal, scale) / (q, k, v, do, lse, dsum, q_seg, ...)
        "attn_train_fwd": lambda a, keep: (tuple(a[0].shape), tuple(a[1].shape), a[5],
                                           None if a[3] is None else keep(a[3])),
        "attn_train_dq": lambda a, keep: (tuple(a[0].shape), tuple(a[1].shape), a[8]),
        "attn_train_dkv": lambda a, keep: (tuple(a[0].shape), tuple(a[1].shape), a[8]),
        # (x, w, eps, mode, want_r) / (x2, w, r, dy2, mode, want_dw), x (..., E):
        # (rows, E, ...), one entry per mode's kernel, both wrapping the same
        # launch function
        "rms_norm_fwd": lambda a, keep: (a[0].numel() // a[0].shape[-1], a[0].shape[-1],
                                         a[0].dtype, a[4]) if a[3] == "model" else None,
        "rms_norm_fwd_fused": lambda a, keep: (a[0].numel() // a[0].shape[-1], a[0].shape[-1],
                                               a[0].dtype, a[4]) if a[3] == "fused" else None,
        "rms_norm_bwd": lambda a, keep: (*a[0].shape, a[0].dtype, a[5]) if a[4] == "model" else None,
        "rms_norm_bwd_fused": lambda a, keep: (*a[0].shape, a[0].dtype, a[5]) if a[4] == "fused"
        else None,
        # (q, k, v, cos, sin, cache_k, cache_v, rows, pos): the shapes and
        # dtypes, the destination of the call
        "rope_kv": lambda a, keep: (tuple(a[0].shape), tuple(a[1].shape), tuple(a[5].shape),
                                    a[0].dtype, a[5].dtype, keep(a[7]), keep(a[8])),
        # the MLA-MoE kernels (phase 31): (h, sel, ...) / (q, kv, ...) shapes
        "moe_experts": lambda a, keep: (tuple(a[0].shape), tuple(a[1].shape), tuple(a[3].shape)),
        "latent_decode": lambda a, keep: (tuple(a[0].shape), tuple(a[1].shape)),
        "mla_prefill": lambda a, keep: (tuple(a[0].shape), tuple(a[2].shape)),
    }
    OPEN = []  # the logs recording now
    capture = None  # the summaries of the capture under way
    originals = {}  # (module, launch function name) -> the function, while wrapped

    @classmethod
    def install(cls, kernels, torch, decode_graph):
        """Wraps StepGraph's capture and call for the rest of the run; the
        kernels' launch functions are wrapped while a log is open."""
        cls.kernels, cls.torch = kernels, torch
        run_and_capture, call = decode_graph.StepGraph._run_and_capture, decode_graph.StepGraph.__call__

        def capture(graph, fn):
            outer, cls.capture = cls.capture, []
            try:
                return run_and_capture(graph, fn)
            finally:
                graph.shape_log, cls.capture = cls.capture, outer

        def replay(graph, fn):
            replaying = graph.captured and not graph.eager
            out = call(graph, fn)
            if replaying:
                for log in cls.OPEN:
                    for n, summary in getattr(graph, "shape_log", ()):
                        log.add(n, summary)
            return out

        decode_graph.StepGraph._run_and_capture = capture
        decode_graph.StepGraph.__call__ = replay

    @classmethod
    def _wrap(cls):
        by_fn = {}  # two kernels may share a launch function (the RMSNorm modes)
        for name, k in cls.kernels.items():
            by_fn.setdefault((k.module, k.launch), []).append(name)
        for (module, launch), names in by_fn.items():
            orig = cls.originals[module, launch] = getattr(module, launch)

            def rec(*args, _orig=orig, _names=tuple(names)):
                capturing = cls.torch.cuda.is_current_stream_capturing()
                keep = (lambda t: t) if capturing else (lambda t: t.clone())
                for n in _names:
                    summary = cls.SUMMARY[n](args, keep)
                    if summary is None:
                        continue
                    if capturing:
                        if cls.capture is not None:
                            cls.capture.append((n, summary))
                    else:
                        for log in cls.OPEN:
                            log.add(n, summary)
                return _orig(*args)

            setattr(module, launch, rec)

    def __init__(self, kernels):
        self.calls = {name: [] for name in kernels}

    def add(self, name, summary):
        if name in ("flash_decode", "paged_flash_decode", "rope_kv"):  # the last step's only
            self.calls[name] = self.calls[name][-1:]
        self.calls[name].append(summary)

    def __enter__(self):
        if not ShapeLog.OPEN:
            ShapeLog._wrap()
        ShapeLog.OPEN.append(self)
        return self

    def __exit__(self, *exc):
        ShapeLog.OPEN.remove(self)
        if not ShapeLog.OPEN:
            for (module, launch), orig in ShapeLog.originals.items():
                setattr(module, launch, orig)
            ShapeLog.originals.clear()


class CallCount:
    """Counts calls of module functions (and times them with a device sync
    after each, where asked) while active."""

    def __init__(self, module, names, timed=(), torch=None):
        self.module, self.names, self.timed, self.torch = module, names, timed, torch
        self.n = {name: 0 for name in names}
        self.seconds = {name: 0.0 for name in names}

    def __enter__(self):
        self._orig = {name: getattr(self.module, name) for name in self.names}
        for name, orig in self._orig.items():
            def wrapped(*a, _orig=orig, _name=name, **kw):
                self.n[_name] += 1
                if _name not in self.timed:
                    return _orig(*a, **kw)
                self.torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _orig(*a, **kw)
                self.torch.cuda.synchronize()
                self.seconds[_name] += time.perf_counter() - t0
                return out

            setattr(self.module, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(self.module, name, orig)


class Swap:
    """Replaces module attributes while active."""

    def __init__(self, module, **repl):
        self.module, self.repl = module, repl

    def __enter__(self):
        self._orig = {k: getattr(self.module, k) for k in self.repl}
        for k, v in self.repl.items():
            setattr(self.module, k, v)
        return self

    def __exit__(self, *exc):
        for k, v in self._orig.items():
            setattr(self.module, k, v)


def write_eit_data(engine, work):
    """e-IT data the way a user prepares it: each synthetic page saved as a
    uint8 .npy, its pseudo embeddings from the port's own batch_calli_align
    (standing in for get_embeddings) as .npy, one JSONL line with the
    question and the page's text as the answer (train.jsonl, 4 pages); and
    a short row a page for the reference check (ref.jsonl: a 448x448 crop,
    one tile, and the first 96 pseudo rows) -> namespace of paths."""
    pages_boxes = [make_page(seed) for seed in range(N_PAGES)]
    pages = [p for p, _ in pages_boxes]
    aligned = engine.batch_calli_align(pages)
    if any(ps is None for ps, _ in aligned):
        log("the detector found no boxes on a synthetic page: pseudo embeddings from the pages' "
            "known boxes")
        aligned = engine.batch_calli_align(pages, ordered_lists=[b for _, b in pages_boxes])
    train, ref = [], []
    for i, (page, (pseudo, _idx)) in enumerate(zip(pages, aligned)):
        pseudo = pseudo.float().cpu().numpy()
        text = "".join(np.random.RandomState(i).choice(list(TRAIN_TEXT), pseudo.shape[0] // 3))
        np.save(os.path.join(work, f"page{i}.npy"), page)
        np.save(os.path.join(work, f"page{i}_pseudo.npy"), pseudo)
        train.append({"image": f"page{i}.npy", "embedding": f"page{i}_pseudo.npy",
                      "conversations": [{"from": "human", "value": QUESTION},
                                        {"from": "gpt", "value": text}]})
        np.save(os.path.join(work, f"crop{i}.npy"), page[600:1048, 170:618])
        np.save(os.path.join(work, f"crop{i}_pseudo.npy"), pseudo[:96])
        ref.append({"image": f"crop{i}.npy", "embedding": f"crop{i}_pseudo.npy",
                    "conversations": [{"from": "human", "value": QUESTION},
                                      {"from": "gpt", "value": text[:32]}]})
    paths = {}
    for name, items in (("train", train), ("ref", ref)):
        paths[name] = os.path.join(work, f"{name}.jsonl")
        with open(paths[name], "w") as f:
            f.writelines(json.dumps(it, ensure_ascii=False) + "\n" for it in items)
    log(f"[train] e-IT data: {N_PAGES} pages, pseudo rows {[a[0].shape[0] for a in aligned]}")
    return types.SimpleNamespace(work=work, **paths)


def plain_training_attention(k_bwd):
    """The training attention's plain versions in the kernels' place (fp32
    math, outputs in the inputs' dtype): (_fwd, _bwd) for a Swap of
    kernels/attention_bwd.py."""
    def fwd(q, k, v, qs, ks, causal, scale):
        o, lse = k_bwd.attention_fwd_lse_reference(q, k, v, qs, ks, causal, scale)
        return o.to(q.dtype), lse

    def bwd(*args):
        dq, dk, dv = k_bwd.attention_bwd_reference(*args)
        return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()

    return fwd, bwd


def grads_rel_l2(grads, grads_p):
    """The relative L2 error of ``grads`` against ``grads_p`` ({path: grad})
    by leaf group: a LoRA leaf's name over all layers, else the tree's first
    key (the projector)."""
    groups = {}
    for path in grads_p:
        key = path.split("/")[-1] if "_lora_" in path else path.split("/")[0]
        d, n = groups.get(key, (0.0, 0.0))
        g, gp = grads[path].float(), grads_p[path].float()
        groups[key] = (d + (g - gp).square().sum().item(), n + gp.square().sum().item())
    # a group whose grads are zero in the plain step (the a leaves of fresh
    # adapters) must be exactly zero here too
    return {k: (d / n) ** 0.5 if n else (0.0 if d == 0 else float("inf"))
            for k, (d, n) in sorted(groups.items())}


class CountsApart:
    """Inside a run with a ShapeLog open (the train CLI's), runs a block with
    every launch count zeroed at its start and the block's launches recorded
    in a ShapeLog of its own in place of the open ones, then puts back the
    counts and the logs of the enclosing run: the eval chats are counted
    alone."""

    def __init__(self, h, counts):
        self.h, self.counts = h, counts

    def __enter__(self):
        self.saved = [c.launches for c in self.counts]
        self.outer = ShapeLog.OPEN[:]
        self.shapes = ShapeLog(self.h.kernels)
        ShapeLog.OPEN[:] = [self.shapes]  # the launch functions stay wrapped
        self.h.zero_counts()
        return self

    def __exit__(self, *exc):
        self.launches, self.decode_steps = self.h.read_counts(), self.h.decode_steps()
        ShapeLog.OPEN[:] = self.outer
        for c, n in zip(self.counts, self.saved):
            c.launches = n


class TrainingReferences:
    """A training step's loss and grads through the kernels against the same
    step on the plain versions of the training attention and RMSNorm
    kernels, beside two witnesses of the comparison's bf16 noise: the step
    through the library's attention (scaled_dot_product_attention, a
    yardstick the port never calls), and the plain step with every attention
    output and gradient moved one bf16 ulp up or down (a fixed random
    pattern a shape, so the remat recompute repeats it)."""

    def __init__(self, h, torch, F, k_bwd, k_rms, internlm2):
        self.h, self.torch = h, torch
        plain_fwd, plain_bwd = plain_training_attention(k_bwd)
        gen, steps = torch.Generator(device=h.dev).manual_seed(2), {}

        def one_ulp(t):  # t (bf16) with each non-zero element one ulp up or down
            if t.shape not in steps:
                steps[t.shape] = (2 * torch.randint(0, 2, t.shape, generator=gen, device=h.dev)
                                  - 1).to(torch.int16)
            bits = t.contiguous().view(torch.int16)
            return torch.where(t != 0, bits + steps[t.shape], bits).view(torch.bfloat16)

        def ulp_fwd(*args):
            o, lse = plain_fwd(*args)
            return one_ulp(o), lse

        def ulp_bwd(*args):
            return tuple(one_ulp(g) for g in plain_bwd(*args))

        def sdpa_attention(q, k, v, q_seg, kv_seg, causal, scale):
            if q_seg is None:
                return F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale,
                                                      enable_gqa=True)
            S = q.shape[2]
            allowed = (q_seg[:, :, None] == kv_seg[:, None, :]) & torch.ones(
                (S, S), dtype=torch.bool, device=q.device).tril()
            return F.scaled_dot_product_attention(q, k, v, attn_mask=allowed[:, None], scale=scale,
                                                  enable_gqa=True)

        self.plain = lambda: [Swap(k_bwd, _fwd=plain_fwd, _bwd=plain_bwd), Swap(k_rms, **h.plain_rms)]
        self.witnesses = {
            "library": lambda: [Swap(internlm2, flash_attention_trainable=sdpa_attention)],
            "plain +-1 ulp": lambda: [Swap(k_bwd, _fwd=ulp_fwd, _bwd=ulp_bwd),
                                      Swap(k_rms, **h.plain_rms)]}

    @staticmethod
    def _under(swaps, fn):
        with contextlib.ExitStack() as stack:
            for swap in swaps:
                stack.enter_context(swap)
            return fn()

    def hold(self, tag, what, loss_and_grads, loss_tol, first=None):
        """``loss_and_grads() -> (loss, {path: grad})`` through the kernels
        (``first``: its result, already taken), on the plain versions and
        under each witness. Fails unless the loss is within ``loss_tol``
        relative, each leaf group's grads within twice the smaller witness
        and all under REF_GRAD_CAP -> the grads' errors by group."""
        h = self.h
        loss_k, grads = first if first is not None else loss_and_grads()
        h.zero_counts()
        loss_p, grads_p = self._under(self.plain(), loss_and_grads)
        if any(h.read_counts()[n] for n in ("attn_train_fwd", "attn_train_dq", "attn_train_dkv")
               + NORM_KERNELS):
            fail(f"[{tag}] the plain-version step launched a kernel: {h.read_counts()}")
        rel = {"kernels": (abs(loss_k - loss_p) / abs(loss_p), grads_rel_l2(grads, grads_p))}
        del grads
        for name, swaps in self.witnesses.items():
            loss_w, grads = self._under(swaps(), loss_and_grads)
            rel[name] = (abs(loss_w - loss_p) / abs(loss_p), grads_rel_l2(grads, grads_p))
            del grads
        del grads_p
        (loss_rel, rel_k), noise = rel["kernels"], [r for name, (_, r) in rel.items() if name != "kernels"]
        log(f"[{tag}] {what} against the plain versions, loss {loss_p:.6f}; loss rel err "
            + ", ".join(f"{name} {r[0]:.3e}" for name, r in rel.items())
            + f" (tol {loss_tol:g}); grads rel L2 err by leaf group, " + " / ".join(rel) + ": "
            + ", ".join(f"{k} " + " / ".join(f"{r[1][k]:.3e}" for r in rel.values()) for k in rel_k)
            + "; max " + " / ".join(f"{max(r[1].values()):.3e}" for r in rel.values()))
        over = [k for k in rel_k if rel_k[k] > 2 * min(r[k] for r in noise)]
        if not (loss_rel <= loss_tol and max(rel_k.values()) <= REF_GRAD_CAP and not over):
            fail(f"[{tag}] {what}: the training step through the kernels disagrees with the plain "
                 f"versions (loss rel err {loss_rel:.3e}, groups beyond twice the noise {over}, "
                 f"max {max(rel_k.values()):.3e} against {REF_GRAD_CAP})")
        self.torch.cuda.empty_cache()
        return rel_k


def train_phases(h, data):
    """Phases 14-16: e-IT training through the CLI (with its eval chats),
    the reference step, and the training attention kernels at the run's
    shapes and the ceiling -> (the final checkpoint's directory, phase 14's
    trained LLM for phase 24)."""
    import functools

    import torch
    import torch.nn.functional as F

    from callireader_tpu_torch.cli import train as train_cli
    from callireader_tpu_torch.kernels import _build
    from callireader_tpu_torch.kernels import attention_bwd as k_bwd
    from callireader_tpu_torch.kernels import rmsnorm as k_rms
    from callireader_tpu_torch.models import internlm2
    from callireader_tpu_torch.runtime import engine as engine_mod
    from callireader_tpu_torch.runtime import generate as gen_mod
    from callireader_tpu_torch.train import checkpoint as ckpt_mod
    from callireader_tpu_torch.train import data as data_mod
    from callireader_tpu_torch.train import e_it

    dev = h.dev

    # ---------------------------------------------------------- 14. train, e-IT, 2b bf16
    def leaf(tree, path):
        return functools.reduce(lambda t, k: t[k], path, tree)

    def checksum(t):  # every bit of a bf16 leaf
        return int(torch.sum(t.contiguous().view(torch.int16), dtype=torch.int64))

    built, before = [], {}
    build_engine = engine_mod.build_engine

    def build_and_checksum(*a, **kw):
        engine = build_engine(*a, **kw)
        before.update({"/".join(p): checksum(leaf(engine.params, p)) for p in TRAIN_FROZEN})
        built.append(engine)
        return engine

    steps, last = [], {}
    make_train_step = e_it.make_train_step
    export_reference_format, exported = ckpt_mod.export_reference_format, {}

    def timed_export(*a, **kw):
        t0 = time.time()
        out = export_reference_format(*a, **kw)
        exported["s"] = time.time() - t0
        return out

    def timed_train_step(*a, **kw):
        step = make_train_step(*a, **kw)

        def timed(state, frozen, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, frozen, batch)
            loss = float(out[1]["loss"])
            torch.cuda.synchronize()
            rows = tuple((batch["segment_ids"] >= 0).sum(1).tolist())  # real tokens a row
            steps.append((time.perf_counter() - t0, loss, batch["input_ids"].shape[1], rows))
            last.update(step=step, state=state, frozen=frozen, batch=batch)
            return out

        return timed

    # the eval chats (--eval-chat-interval 1: one after each update), each
    # counted apart from the training run; the second is run again uncaptured
    chats = []
    engine_chat, generate = engine_mod.CalliReaderEngine.chat, gen_mod.generate_from_embeds

    def counted_chat(engine, *a, **kw):
        gens = []

        def keep(*ga, **gkw):
            out = generate(*ga, **gkw)
            gens.append((out[0][0, :int(out[1][0])].cpu(), out[0].requires_grad))
            return out

        t0 = time.perf_counter()
        with CountsApart(h, _build.COUNTS) as apart, CallCount(internlm2, ("prefill",)) as st, \
                Swap(gen_mod, generate_from_embeds=keep):
            resp = engine_chat(engine, *a, **kw)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eager = None
        if chats:  # the second chat: the first chat's graphs replayed on the moved adapters
            with CountsApart(h, _build.COUNTS), \
                    Swap(gen_mod, generate_from_embeds=lambda *ga, **gkw: keep(*ga, eager=True, **gkw)):
                eager = engine_chat(engine, *a, **kw)
        chats.append(types.SimpleNamespace(resp=resp, eager=eager, gens=gens, wall=wall,
                                           n_pre=st.n["prefill"], shapes=apart.shapes,
                                           launches=apart.launches, n_dec=apart.decode_steps))
        return resp

    out_dir = os.path.join(data.work, "out")
    argv = ["--data", data.train, "--image-root", data.work, "--out", out_dir,
            "--preset", TRAIN_PRESET, "--random-init", "--config", "e_it", "--max-iters", "2",
            "--log-interval", "1", "--eval-chat-interval", "1"]
    h.zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with ShapeLog(h.kernels) as shapes, Swap(engine_mod, build_engine=build_and_checksum), \
            Swap(e_it, make_train_step=timed_train_step), \
            Swap(ckpt_mod, export_reference_format=timed_export), \
            Swap(engine_mod.CalliReaderEngine, chat=counted_chat):
        train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = h.read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    engine, state, frozen = built[0], last["state"], last["frozen"]
    cfg = engine.cfg
    L, Lv, n_micro = cfg.llm.num_hidden_layers, cfg.vision.num_hidden_layers, len(steps)
    log(f"[train] cli.train: {n_micro} micro-steps in {wall:.3f} s (engine build and data "
        f"included); bucket and real tokens per row {[st[2:] for st in steps]}; launches "
        f"{launches}; peak memory {peak:.2f} GiB")
    # the norms under remat: each layer's two forward and again in the
    # recompute, the final norm once; one backward each (frozen weights: no dw)
    want = {"attn_train_fwd": 2 * L * n_micro, "attn_train_dq": L * n_micro,
            "attn_train_dkv": L * n_micro, "vit_attention": Lv * n_micro,
            "rms_norm_fwd": (4 * L + 1) * n_micro, "rms_norm_bwd": (2 * L + 1) * n_micro}
    if n_micro != 4 or any(launches[n] != want.get(n, 0) for n in launches):
        fail(f"[train] {n_micro} micro-steps (want 4: 2 updates x accum 2); launches {launches}, "
             f"want {want} and 0 elsewhere")
    if not all(np.isfinite(st[1]) for st in steps):
        fail(f"[train] a non-finite loss: {[st[1] for st in steps]}")
    if any(want_dw for *_, want_dw in shapes.calls["rms_norm_bwd"]):
        fail("[train] an RMSNorm backward computed dw for a frozen norm weight")
    h.keep_norms("train", shapes, launches)
    eval_chat_checks(h, chats, cfg, L)
    lora_b = {n: v for n, v in state.trainable["llm"]["layers"].items() if n.endswith("_lora_b")}
    unmoved = [n for n, b in lora_b.items() if not bool((b.detach().abs().amax(dim=(1, 2)) > 0).all())]
    if len(lora_b) != 7 or unmoved:
        fail(f"[train] LoRA b leaves still zero in some layer after two updates: {unmoved}")
    after = {"/".join(p): checksum(leaf(engine.params, p)) for p in TRAIN_FROZEN}
    if after != before:
        fail(f"[train] frozen leaves changed: {[k for k in before if before[k] != after[k]]}")

    def zeros_like_tree(tree):
        if isinstance(tree, dict):
            return {k: zeros_like_tree(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(zeros_like_tree(v) for v in tree)
        return None if tree is None else torch.zeros_like(tree)

    template = e_it.TrainState(zeros_like_tree(state.trainable),
                               {k: zeros_like_tree(v) if isinstance(v, dict) else 0
                                for k, v in state.opt_state.items()}, 0)
    restored = ckpt_mod.restore_train_state(os.path.join(out_dir, "final"), template)

    def state_tensors(st):
        return e_it.flatten({"trainable": st.trainable, "opt_state": {
            k: v for k, v in st.opt_state.items() if isinstance(v, dict)}})

    live, back = state_tensors(state), state_tensors(restored)
    if restored.step != state.step or restored.opt_state["count"] != state.opt_state["count"] \
            or set(live) != set(back) or not all(torch.equal(live[k], back[k]) for k in live):
        fail("[train] the final checkpoint does not restore the trained state")
    del template, restored, live, back
    export_readback(out_dir, state, frozen, cfg, exported["s"])
    with open(os.path.join(out_dir, "train_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    step_ms = [1e3 * st[0] for st in steps]
    tok_s = sum(sum(st[3]) for st in steps[1:]) / (sum(step_ms[1:]) / 1e3)
    log(f"[train] losses {[round(st[1], 4) for st in steps]}; grad norms "
        f"{[r['grad_norm'] for r in recs]}; ms per micro-step: first {step_ms[0]:.1f}, then "
        f"{[round(t, 1) for t in step_ms[1:]]} (host clock, a device sync at each end); "
        f"TrainThroughput at the last update (supervised tokens only, first step's time left "
        f"out): {recs[-1]['tokens_per_sec']} tokens/s; over micro-steps 2-{n_micro}, every real "
        f"token: {tok_s:.1f} tokens/s; LoRA b leaves moved in every layer, "
        f"{len(TRAIN_FROZEN)} frozen leaves unchanged bit for bit, the final checkpoint restores")
    fn = functools.partial(last["step"], state, frozen, last["batch"])
    t0 = time.perf_counter()
    for _ in range(2):  # one accumulating micro-step, one that updates
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 2 * 1e3
    kern, idle = device_kernels(fn, torch, 2)
    # every micro-step launches the dq kernel once a layer: the trace's count
    # of it says how many micro-steps the trace holds
    captured = sum(c for name, (_, c) in kern.items() if "dq_kernel" in name) / L
    if not captured:
        log(f"[train] micro-step profile: {host_ms:.1f} ms on the host clock; the profiler trace "
            f"holds no training kernels (device ms not measured)")
    else:
        busy = sum(us for us, _ in kern.values()) / captured / 1e3
        top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
        # the forward attention loop's kernels run here only as the ViT's
        top += [kv for kv in kern.items() if "flash_fwd_kernel" in kv[0] and kv not in top]
        log(f"[train] micro-step profile: {host_ms:.1f} ms on the host clock (no profiler), "
            f"{busy:.1f} ms of device kernels ({captured:g} of 2 micro-steps in the trace, "
            f"{sum(c for _, c in kern.values()) / captured:.0f} kernels a step); device idle in the "
            f"trace {100 * idle:.1f}% (profiler on), 1 - device / host ms "
            f"{100 * (1 - busy / host_ms):.1f}% (two runs); by kernel (ms a step, launches a step): "
            + "; ".join(f"{name[:48]} {us / captured / 1e3:.1f} ({c / captured:.0f})"
                        for name, (us, c) in top))

    # ---------------------------------------------------------- 15. reference
    # one micro-step through the kernels against the same step with the three
    # kernels swapped for their plain versions, on two batches; beside it two
    # witnesses of the comparison's bf16 noise: the step through the library's
    # attention (a yardstick the port never calls), and the plain step with
    # every attention output and gradient moved one bf16 ulp up or down (a
    # fixed random pattern a shape, so the remat recompute repeats it)
    ref_ds = data_mod.EITDataset(data.ref, cfg, engine.tok, image_root=data.work)
    params = e_it.merge_params(state.trainable, frozen)
    flat = e_it.flatten(state.trainable)

    def loss_and_grads(batch):
        loss, _ = e_it.eit_loss(params, cfg, batch, policy=engine.policy, remat=True)
        grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True,
                                    materialize_grads=True)
        return loss.item(), dict(zip(flat, grads))

    refs = TrainingReferences(h, torch, F, k_bwd, k_rms, internlm2)
    for b in range(len(ref_ds) // 2):
        batch = data_mod.to_device(data_mod.collate([ref_ds[2 * b], ref_ds[2 * b + 1]]), dev)
        if batch["input_ids"].shape[1] > 512:
            fail(f"[reference] rows of {batch['input_ids'].shape[1]} tokens, want <= 512")
        # the loss bar as the serving references'
        refs.hold("reference", f"batch {b + 1}: one micro-step on 2 rows of "
                  f"{batch['input_ids'].shape[1]} tokens through the {L}-layer trained model",
                  functools.partial(loss_and_grads, batch), loss_tol=5e-2)
    # phase 24 trains on with this LLM: the base and phase 14's final adapters
    post = types.SimpleNamespace(llm=params["llm"], cfg=cfg, tok=engine.tok, policy=engine.policy)
    del engine, built, state, frozen, params, flat, last, batch, fn, lora_b, chats
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 16. kernels of the training path
    groups = {}
    for q_shape, k_shape, causal, seg in shapes.calls["attn_train_fwd"]:
        n, first = groups.get((q_shape, k_shape, causal), (0, seg))
        groups[q_shape, k_shape, causal] = (n + 1, first)
    if sum(n for n, _ in groups.values()) != launches["attn_train_fwd"] \
            or len(shapes.calls["attn_train_dq"]) != launches["attn_train_dq"] \
            or len(shapes.calls["attn_train_dkv"]) != launches["attn_train_dkv"]:
        fail("[train] the shape log disagrees with the training kernels' counts")
    cases = [(f"train B={q[0]} S={q[2]}", q, k, seg) for (q, k, _), (_, seg) in groups.items()]
    B, Hq, _, D = cases[0][1]
    Hkv = cases[0][2][1]
    S = TRAIN_CEILING
    # a shape the path did not run: its entries carry the path's launches
    cases.append((f"ceiling B=1 S={S}, off the path; launches of {cases[0][0]}", (1, Hq, S, D),
                  (1, Hkv, S, D), torch.zeros((1, S), dtype=torch.int32, device=dev)))
    for label, q_shape, k_shape, seg in cases:
        train_attention_rows(h, label, q_shape, k_shape, seg, launches, k_bwd, F)
        torch.cuda.empty_cache()
    return os.path.join(out_dir, "final"), post


def eval_chat_checks(h, chats, cfg, L):
    """Phase 14's two eval chats (the train CLI's --eval-chat-interval 1 on
    the live adapters): each prefilled and decoded through the kernels (the
    prefill, flash_decode L times a decode step, the RMSNorm forward) and
    nothing else, a string answer of token ids below the real vocabulary,
    its tokens not tracked by autograd; the second chat, whose decode
    replays the first chat's CUDA graphs after the optimizer moved the
    adapters in place, gives the token ids of the same chat run uncaptured.
    Then flash_decode against its plain version at the chat's shape."""
    import torch

    vocab = cfg.llm.real_vocab_size or cfg.llm.vocab_size
    others = ("vit_attention", "int8_matmul", "int8_matmul_nt", "paged_flash_decode",
              "attn_train_fwd", "attn_train_dq", "attn_train_dkv")
    if len(chats) != 2:
        fail(f"[eval-chat] {len(chats)} eval chats in two updates, want 2")
    for i, c in enumerate(chats, 1):
        label = f"eval-chat @{i}"
        toks, tracked = c.gens[0]
        lz = c.launches
        if not isinstance(c.resp, str) or tracked or not ((toks >= 0) & (toks < vocab)).all() \
                or not 1 <= toks.numel() <= EVAL_CHAT_TOKENS:
            fail(f"[{label}] response {c.resp!r}: {toks.numel()} token ids (vocabulary {vocab}), "
                 f"tracked by autograd {tracked}")
        if not lz["flash_attention"] or not c.n_dec or lz["flash_decode"] != L * c.n_dec \
                or any(lz[n] for n in others):
            fail(f"[{label}] launches {lz} for {c.n_pre} prefill(s) and {c.n_dec} decode steps")
        h.check_norms(label, lz, L, c.n_pre + c.n_dec)
        log(f"[{label}] {c.wall * 1e3:.1f} ms (host clock, a device sync at the end; the first "
            f"captures its decode graphs), {c.n_pre} prefill, {c.n_dec} decode steps, "
            f"{toks.numel()} new tokens, response {c.resp[:30]!r}; launches {lz}")
    second = chats[1]
    if len(second.gens) != 2 or not torch.equal(second.gens[0][0], second.gens[1][0]) \
            or second.eager != second.resp:
        fail("[eval-chat @2] the replayed decode's token ids differ from the same chat run "
             "uncaptured")
    log(f"[eval-chat @2] token ids of the replayed graphs = the same chat uncaptured "
        f"({second.gens[0][0].numel()} tokens)")
    h.keep_norms("eval-chat", second.shapes, second.launches)
    h.flash_decode_row("eval-chat", second.shapes, second.launches)


def post_training_phase(h, post, work):
    """Phase 24: post-training at full width on phase 14's LLM (the 2b: the
    8b's widths, 8 layers), one step each of SFT on packed rows, ORPO and the
    reward model on its final adapters and DPO from fresh ones, through the
    train modules' own steps, each counted, timed and held against the same
    step on the plain versions of the training and RMSNorm kernels; then the
    training kernels at the SFT and DPO steps' shapes and segment ids."""
    import torch
    import torch.nn.functional as F

    from callireader_tpu_torch.kernels import attention_bwd as k_bwd
    from callireader_tpu_torch.kernels import rmsnorm as k_rms
    from callireader_tpu_torch.models import internlm2
    from callireader_tpu_torch.train import data as data_mod
    from callireader_tpu_torch.train import dpo, e_it, lora, reward, sft_data

    dev, cfg, tok, policy = h.dev, post.cfg, post.tok, post.policy
    L = cfg.llm.num_hidden_layers
    rng = np.random.RandomState(24)

    def text(n):
        return "".join(rng.choice(list(TRAIN_TEXT), n))

    # the data: a JSONL corpus packed into 2048-token rows; two preference pairs
    t0 = time.time()
    corpus = os.path.join(work, "sft.jsonl")
    with open(corpus, "w") as f:
        f.writelines(json.dumps({"content": text(n)}, ensure_ascii=False) + "\n"
                     for n in POST_SFT_DOCS)
    docs = sft_data.JsonlTextDataset(corpus)
    packed = sft_data.PackedTextDataset(docs, tok, packed_length=POST_PACKED)
    sft_np = next(sft_data.packed_loader(packed, 2))
    n_segs = [len(set(r[r >= 0].tolist())) for r in sft_np["segment_ids"]]
    pairs = [{"prompt": QUESTION + text(p), "chosen": text(c), "rejected": text(r)}
             for p, c, r in POST_PAIRS]
    pref_np = dpo.preference_collate(pairs, tok)
    prep_s = time.time() - t0
    doc_tokens = [len(tok.encode(docs[i])) for i in range(len(docs))]
    if sft_np["input_ids"].shape != (2, POST_PACKED) or min(n_segs) < 3 \
            or pref_np["input_ids"].shape != (4, 2048):
        fail(f"[post] SFT batch {sft_np['input_ids'].shape} with {n_segs} segments a row, "
             f"preference batch {pref_np['input_ids'].shape}")
    log(f"[post] data in {prep_s:.3f} s: {len(docs)} documents of {min(doc_tokens)}-"
        f"{max(doc_tokens)} tokens packed into {len(packed)} rows of {POST_PACKED}; the SFT "
        f"batch's rows hold {n_segs} segments, "
        f"{[int((r >= 0).sum()) for r in sft_np['segment_ids']]} real tokens; preference rows "
        f"of {[int((r >= 0).sum()) for r in pref_np['segment_ids']]} tokens in the 2048 bucket")
    sft_batch = data_mod.to_device(sft_np, dev)
    pref = data_mod.to_device(pref_np, dev)

    llm = post.llm
    # DPO from fresh adapters (b = 0), as a DPO run starts: the policy is the
    # reference, so the loss is log 2 in every route and the grads carry no
    # noise of a log-likelihood difference (the a leaves' grads are zero)
    fresh = lora.add_lora(dpo._strip_lora(llm), cfg.llm, torch.Generator(device=dev).manual_seed(5),
                          rank=llm["layers"]["wq_lora_a"].shape[-1])
    r_cfg = dataclasses.replace(cfg, llm=reward.long_context_config(
        cfg.llm, 2 * cfg.llm.max_position_embeddings))
    if r_cfg.llm.rope_scaling_type != "linear" or r_cfg.llm.rope_scaling_factor != 2.0:
        fail(f"[post] long_context_config gave {r_cfg.llm.rope_scaling_type} x "
             f"{r_cfg.llm.rope_scaling_factor}")
    # first update at lr 0 (the warm-up's start), so every step reads phase 14's adapters
    tc = e_it.TrainConfig(learning_rate=1e-5, total_steps=10, warmup_ratio=0.0)
    dpo_cfg, orpo_cfg = dpo.DPOConfig(), dpo.DPOConfig(loss_type="orpo")
    # the norms under remat; no backward for the first layer's attention
    # norm, whose input (the frozen embedding table's rows) needs no gradient
    norms_remat = {"rms_norm_fwd": 4 * L + 1, "rms_norm_bwd": 2 * L}
    train3 = {"attn_train_dq": L, "attn_train_dkv": L}
    steps = {
        # name: (params tree, batch, loss(params, batch), make the step(tx), launches)
        "sft": ({"llm": llm}, sft_batch,
                lambda p, b: e_it.eit_loss(p, cfg, b, policy=policy, remat=True),
                lambda tx: e_it.make_train_step(cfg, tc, tx, policy=policy),
                {"attn_train_fwd": 2 * L, **train3, **norms_remat}),
        # the policy's forward (and its recompute), the reference's under no_grad
        "dpo": ({"llm": fresh}, pref,
                lambda p, b: dpo.dpo_loss(p, cfg, b, dpo_cfg, policy=policy, remat=True),
                lambda tx: dpo.make_dpo_train_step(cfg, dpo_cfg, tx, policy=policy),
                {"attn_train_fwd": 3 * L, **train3, "rms_norm_fwd": 6 * L + 2,
                 "rms_norm_bwd": 2 * L}),
        "orpo": ({"llm": llm}, pref,
                 lambda p, b: dpo.dpo_loss(p, cfg, b, orpo_cfg, policy=policy, remat=True),
                 lambda tx: dpo.make_dpo_train_step(cfg, orpo_cfg, tx, policy=policy),
                 {"attn_train_fwd": 2 * L, **train3, **norms_remat}),
        "reward": ({"llm": reward.add_value_head(llm, cfg.llm,
                                                 torch.Generator(device=dev).manual_seed(24))},
                   pref, lambda p, b: reward.reward_loss(p, r_cfg, b, policy=policy, remat=True),
                   lambda tx: reward.make_reward_train_step(r_cfg, tx, policy=policy),
                   {"attn_train_fwd": 2 * L, **train3, **norms_remat}),
    }
    refs = TrainingReferences(h, torch, F, k_bwd, k_rms, internlm2)
    kept = {}
    for name, (params, batch, loss_fn, make_step, want) in steps.items():
        state, frozen, tx = e_it.create_train_state(params, tc)
        step = make_step(tx)
        flat = e_it.flatten(state.trainable)
        h.zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with ShapeLog(h.kernels) as shapes:
            t0 = time.perf_counter()
            state, metrics = step(state, frozen, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
        launches = h.read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not np.isfinite(loss) or any(launches[n] != want.get(n, 0) for n in launches):
            fail(f"[post {name}] loss {loss}; launches {launches}, want {want} and 0 elsewhere")
        if name == "dpo" and abs(loss - float(np.log(2.0))) > 1e-6:
            fail(f"[post dpo] the fresh adapters' DPO loss is {loss!r}, not log 2 within 1e-6")
        kept[name] = (shapes, launches)
        merged = e_it.merge_params(state.trainable, frozen)

        def loss_and_grads():
            loss_t, _ = loss_fn(merged, batch)
            grads = torch.autograd.grad(loss_t, list(flat.values()), allow_unused=True,
                                        materialize_grads=True)
            return loss_t.item(), dict(zip(flat, grads))

        # the same loss and grads through the kernels, under the profiler
        first, kern = profiled(loss_and_grads, torch)
        dev_ms = sum(us for us, _ in kern.values()) / 1e3
        attn_ms = sum(us for n, (us, _) in kern.items()
                      if "flash_fwd_kernel" in n or "dq_kernel" in n or "dkv_kernel" in n) / 1e3
        log(f"[post {name}] one step ({', '.join(f'{k} {float(v):.5g}' for k, v in metrics.items())})"
            f" in {step_ms:.1f} ms (host clock, a device sync at each end), peak memory "
            f"{peak:.2f} GiB; launches {launches}; its loss and grads again under the profiler: "
            f"{dev_ms:.1f} ms of device kernels, {attn_ms:.1f} ms of them the training attention")
        refs.hold(f"post {name}", "one step's loss and grads", loss_and_grads, loss_tol=1e-3,
                  first=first)
        del state, frozen, tx, step, flat, merged, metrics, first
        torch.cuda.empty_cache()

    del fresh, steps

    # the training kernels at the SFT (packed) and DPO steps' shapes and segment ids
    for name, label in (("sft", "SFT, packed rows"), ("dpo", "DPO, [chosen; rejected]")):
        shapes, launches = kept[name]
        q_shape, k_shape, _causal, seg = shapes.calls["attn_train_fwd"][0]
        train_attention_rows(h, f"{label} B={q_shape[0]} S={q_shape[2]}", q_shape, k_shape, seg,
                             launches, k_bwd, F)
        torch.cuda.empty_cache()


def export_readback(out_dir, state, frozen, cfg, export_s):
    """Phase 14's export_official read back with the port's reader: the
    vocab tables, the final norm and every leaf of the first and last layers
    equal, as fp32, merge_lora(merge_params(final state)) bit for bit."""
    import torch

    from callireader_tpu_torch.runtime import weights
    from callireader_tpu_torch.train import e_it, lora

    export_dir = os.path.join(out_dir, "export_official")
    files = {f: os.path.getsize(os.path.join(export_dir, f)) for f in os.listdir(export_dir)}
    t0 = time.time()
    sd = weights.load_safetensors_dir(export_dir)
    llm = lora.merge_lora(e_it.merge_params(state.trainable, frozen)["llm"])
    layers, L = llm["layers"], cfg.llm.num_hidden_layers
    pairs = [("language_model.model.tok_embeddings.weight", sd["language_model.model.tok_embeddings.weight"],
              llm["tok_embeddings"]),
             ("language_model.output.weight", sd["language_model.output.weight"], llm["output"]),
             ("language_model.model.norm.weight", sd["language_model.model.norm.weight"],
              llm["norm"])]
    for i in (0, L - 1):
        pre = f"language_model.model.layers.{i}."
        qkv = weights.split_wqkv(sd[pre + "attention.wqkv.weight"], cfg.llm)
        pairs += [(f"{pre}attention.wqkv.weight ({n})", t, layers[n][i])
                  for n, t in zip(("wq", "wk", "wv"), qkv)]
        pairs += [(pre + theirs, sd[pre + theirs].T if transposed else sd[pre + theirs], layers[ours][i])
                  for ours, theirs, transposed in (
                      ("wo", "attention.wo.weight", True), ("w1", "feed_forward.w1.weight", True),
                      ("w3", "feed_forward.w3.weight", True), ("w2", "feed_forward.w2.weight", True),
                      ("attn_norm", "attention_norm.weight", False),
                      ("ffn_norm", "ffn_norm.weight", False))]
    bad = [name for name, got, want in pairs
           if got.dtype != torch.float32 or want.dtype != torch.bfloat16
           or not torch.equal(bits(got.to(want.device)), bits(want.float()))]
    read_s = time.time() - t0
    moved = int((layers["wq"][L - 1] != frozen["llm"]["layers"]["wq"][L - 1]).sum())
    log(f"[train] export_official: {sum(files.values()) / 1e9:.3f} GB in {len(files)} files, "
        f"written in {export_s:.3f} s ({sum(files.values()) / export_s / 1e9:.3f} GB/s, the "
        f"adapters merged first); read back with the port's reader: {len(pairs) - len(bad)} of "
        f"{len(pairs)} tensors (the vocab tables, the final norm, layers 0 and {L - 1}) equal "
        f"merge_lora(merge_params(final state)) bit for bit as fp32, in {read_s:.3f} s; "
        f"{moved} elements of layer {L - 1}'s wq moved by the adapters")
    if bad or not moved:
        fail(f"[train] export_official disagrees with the merged final state: {bad}; "
             f"{moved} elements moved")


def train_attention_rows(h, label, q_shape, k_shape, seg, launches, k_bwd, F):
    """The forward, dq and dk/dv kernels against their plain versions at one
    shape (causal, the given segment ids or none), beside scaled_dot_product_attention
    and its autograd backward (the backward computes dq, dk and dv at once; its
    time stands in the dk/dv row). The plain versions run one (batch row, KV
    head) at a time so that their fp32 scores fit."""
    torch, dev, rnd = h.torch, h.dev, h.rnd
    B, Hq, S, D = q_shape
    Hkv = k_shape[1]
    G, scale = Hq // Hkv, D ** -0.5
    q, do, k, v = rnd(q_shape), rnd(q_shape), rnd(k_shape), rnd(k_shape)
    o, lse = k_bwd._launch_fwd(q, k, v, seg, seg, True, scale)
    dsum = (do.float() * o.float()).sum(-1)
    allowed = torch.ones((S, S), dtype=torch.bool, device=dev).tril()
    if seg is not None:
        allowed = (seg[:, :, None] == seg[:, None, :]) & allowed
    pairs = int(allowed.sum().item()) * (B if seg is None else 1)
    causal_only = seg is None or bool((seg == 0).all())
    seg_of = (lambda sb: None) if seg is None else (lambda sb: seg[sb])

    def chunks():
        for b in range(B):
            for j in range(Hkv):
                yield b, slice(b, b + 1), slice(j * G, (j + 1) * G), slice(j, j + 1)

    def plain_fwd():
        out = torch.empty(q_shape, dtype=torch.float32, device=dev)
        out_lse = torch.empty(q_shape[:3], dtype=torch.float32, device=dev)
        for b, sb, sq, sk in chunks():
            out[sb, sq], out_lse[sb, sq] = k_bwd.attention_fwd_lse_reference(
                q[sb, sq], k[sb, sk], v[sb, sk], seg_of(sb), seg_of(sb), True, scale)
        return out, out_lse

    def plain_bwd():
        dq = torch.empty(q_shape, dtype=torch.float32, device=dev)
        dk = torch.empty(k_shape, dtype=torch.float32, device=dev)
        dv = torch.empty(k_shape, dtype=torch.float32, device=dev)
        for b, sb, sq, sk in chunks():
            dq[sb, sq], dk[sb, sk], dv[sb, sk] = k_bwd.attention_bwd_reference(
                q[sb, sq], k[sb, sk], v[sb, sk], seg_of(sb), seg_of(sb), o[sb, sq], lse[sb, sq],
                do[sb, sq], True, scale)
        return dq, dk, dv

    lse_err = (lse - plain_fwd()[1]).abs().max().item()
    log(f"attn_train_fwd [{label}] lse (fp32) max abs err {lse_err:.3e} (tol 1e-4)")
    if lse_err > 1e-4:
        fail(f"attn_train_fwd: lse disagrees with its plain version at {label}")

    def sdpa(qq, kk, vv):
        if causal_only:
            return F.scaled_dot_product_attention(qq, kk, vv, is_causal=True, enable_gqa=True)
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=allowed[:, None],
                                              enable_gqa=True)

    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out_lib = sdpa(qg, kg, vg)

    def sdpa_bwd():
        return torch.autograd.grad(out_lib, (qg, kg, vg), do, retain_graph=True)

    seg_bytes = 0 if seg is None else 8 * seg.numel()
    shape_desc = f"[{label}] B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} causal, {pairs} attended pairs"
    n2 = 2 * q.numel() + 4 * k.numel()  # q, k, v in bf16
    rows = (
        ("attn_train_fwd", lambda: k_bwd._launch_fwd(q, k, v, seg, seg, True, scale)[0],
         lambda: plain_fwd()[0], lambda: sdpa(q, k, v), None,
         n2 + 2 * q.numel() + 4 * lse.numel() + seg_bytes, 2),
        ("attn_train_dq",
         lambda: k_bwd._launch_dq(q, k, v, do, lse, dsum, seg, seg, True, scale),
         lambda: plain_bwd()[0], None, None,
         n2 + 4 * q.numel() + 8 * lse.numel() + seg_bytes, 3),
        ("attn_train_dkv",
         lambda: torch.cat(k_bwd._launch_dkv(q, k, v, do, lse, dsum, seg, seg, True, scale), 2),
         lambda: torch.cat(plain_bwd()[1:], 2), sdpa_bwd,
         lambda: k_bwd._launch_dkv(q, k, v, do, lse, dsum, seg, seg, True, scale),
         n2 + 2 * q.numel() + 4 * k.numel() + 8 * lse.numel() + seg_bytes, 4),
    )
    for name, run_k, run_plain, run_lib, time_k, nbytes, products in rows:
        r = h.row_for(name, shape_desc, run_k, run_plain, run_lib, nbytes=nbytes,
                      flops=2 * pairs * Hq * D * products, time_k=time_k)
        h.results.setdefault(name, []).append((label, launches[name], r))



def cli_phases(h, final_dir, work):
    """Phases 17-18: cli.inference on the int8 LLM with phase 14's e-IT
    adapter (one page, then a folder of two), then beam search, plain chat
    and stream_generate on the engine it built."""
    import torch

    from callireader_tpu_torch.cli import chat as chat_cli
    from callireader_tpu_torch.cli import common as cli_common
    from callireader_tpu_torch.cli import inference as inf_cli
    from callireader_tpu_torch.models import internlm2
    from callireader_tpu_torch.runtime import agent as agent_mod
    from callireader_tpu_torch.runtime import generate as gen_mod
    from callireader_tpu_torch.runtime import quantize as quant_mod
    from callireader_tpu_torch.runtime import weights
    from callireader_tpu_torch.utils.profiling import SPANS

    page_path = os.path.join(work, "page.npy")
    np.save(page_path, make_page(0)[0])
    folder = os.path.join(work, "pages")
    os.makedirs(folder)
    for seed in (1, 2):
        np.save(os.path.join(folder, f"page{seed}.npy"), make_page(seed)[0])
    cli_path = ("vit_attention", "flash_attention", "flash_decode", "int8_matmul",
                "int8_matmul_nt", "rms_norm_fwd")

    # ---------------------------------------------------------- 17. cli.inference, int8 + adapter
    kept, gens = {}, []
    layer = 7  # a host check of one merged leaf: wq of this layer
    draw_base, build_cli = weights.init_params, cli_common.build_engine
    quantize, generate = quant_mod.quantize_llm_int8, gen_mod.generate_from_embeds

    def base_and_keep(*a, **kw):  # the random base the adapter merges onto
        params = draw_base(*a, **kw)
        kept["base"] = params["llm"]["layers"]["wq"][layer].cpu()
        return params

    def cli_and_keep(**kw):
        t0 = time.time()
        kept["engine"] = build_cli(**kw)
        torch.cuda.synchronize()
        kept["build_s"] = time.time() - t0
        return kept["engine"]

    def quantize_and_keep(llm):
        kept["merged"] = llm["layers"]["wq"][layer].cpu()
        return quantize(llm)

    def generate_and_keep(*a, **kw):
        out = generate(*a, **kw)
        gens.append((out[0].cpu(), out[1].cpu()))
        return out

    def run_cli(label, argv):
        """cli.inference.main with every count zeroed just before and read
        just after; its printout captured."""
        engine = kept.get("engine")
        if engine is not None:
            SPANS.reset()
        gens.clear()
        h.zero_counts()
        torch.cuda.reset_peak_memory_stats()
        out = io.StringIO()
        t0 = time.time()
        with ShapeLog(h.kernels) as shapes, \
                CallCount(internlm2, ("prefill",), timed=("prefill",), torch=torch) as steps, \
                Swap(gen_mod, generate_from_embeds=generate_and_keep), \
                contextlib.redirect_stdout(out):
            inf_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = h.read_counts()
        engine = kept["engine"]
        cfg = engine.cfg.llm
        L, vocab = cfg.num_hidden_layers, cfg.real_vocab_size or cfg.vocab_size
        n_pre, n_dec = steps.n["prefill"], h.decode_steps()
        missing = [n for n in cli_path if launches[n] == 0]
        char_calls = [a for a in shapes.calls["vit_attention"]
                      if a[0][-1] // 3 // a[1] != engine.cfg.vision.head_dim]
        if missing or not char_calls:
            fail(f"[{label}] kernels never launched: {missing}; char tower calls "
                 f"{len(char_calls)}; launches {launches}")
        if launches["flash_decode"] != L * n_dec or launches["int8_matmul"] != 4 * L * n_dec \
                or launches["int8_matmul_nt"] != n_dec + n_pre:
            fail(f"[{label}] launches {launches} for {n_pre} prefills and {n_dec} decode steps")
        h.check_norms(label, launches, L, n_pre + n_dec)
        toks = [t[0, :int(n[0])] for t, n in gens]
        if len(toks) != n_pre or not all(((t >= 0) & (t < vocab)).all() for t in toks):
            fail(f"[{label}] token ids outside the vocabulary ({vocab}) or a missing generate")
        spans = SPANS.totals
        step_ms = spans["decode"] / n_dec * 1e3
        lines = out.getvalue().splitlines()
        log(f"[{label}] {wall:.3f} s wall (engine build {kept['build_s']:.3f} s in the first call); "
            f"{n_pre} prompt(s) of {[int(t.numel()) for t in toks]} new tokens; prefill "
            f"{steps.seconds['prefill'] / n_pre:.4f} s each; {n_dec} decode steps at {step_ms:.3f} ms "
            f"a step (host clock, the decode spans); cache slots "
            f"{[tuple(c[1])[3] for c in shapes.calls['flash_decode'][-1:]]}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; spans (s) "
            + json.dumps({k: round(v, 4) for k, v in spans.items()}) + f"; launches {launches}; "
            f"printed {len(lines)} lines, first {[ln[:60] for ln in lines[:3]]}")
        return shapes, launches

    argv = ["--preset", TRAIN_PRESET, "--random-init", "--quant", "int8",
            "--adapter", final_dir]
    with Swap(weights, init_params=base_and_keep), \
            Swap(cli_common, build_engine=cli_and_keep), \
            Swap(quant_mod, quantize_llm_int8=quantize_and_keep):
        shapes, launches = run_cli("cli page", ["--tgt", page_path, *argv])
    engine = kept["engine"]
    h.keep_norms("cli", shapes, launches)
    h.flash_decode_row("cli", shapes, launches)
    # the (K, N) kernel and the LM head at the CLI's one row: every launch of
    # the run at M = 1, a quarter of the (K, N) launches per projection
    counts = h.int8_rows("cli", shapes, launches, engine.params["llm"])
    want = {**{(label, 1): launches["int8_matmul"] // 4 for label in ("wqkv", "wo", "w13", "w2")},
            ("lm_head", 1): launches["int8_matmul_nt"]}
    if counts != want:
        fail(f"[cli] int8 launches by projection and rows {counts}, expected {want}")
    log("[cli] int8 launches by projection and rows: "
        + ", ".join(f"{label} M={M}: {n}" for (label, M), n in counts.items()))

    # the merged leaf: base + scale * a @ b from the checkpoint, before int8
    saved = torch.load(os.path.join(final_dir, "state.pt"), map_location="cpu", mmap=True,
                       weights_only=True)["tensors"]
    a = saved["trainable/llm/layers/wq_lora_a"][layer].float()
    b = saved["trainable/llm/layers/wq_lora_b"][layer].float()
    want = (kept["base"].float() + (a @ b) * (256.0 / 128)).bfloat16().float()
    got = kept["merged"].float()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(got.abs(), want.abs()).clamp_min(2**-126))) - 7)
    diff = (got - want).abs()
    moved = int((kept["merged"] != kept["base"]).sum())
    log(f"[cli] adapter merge, layer {layer} wq: {moved} of {got.numel()} elements moved from the "
        f"base; against base + 2 * a @ b of the checkpoint, max abs err {diff.max().item():.3e}, "
        f"{int((diff > 0).sum())} elements one bf16 ulp apart (fp32 products in another order)")
    if not moved or not (diff <= ulp).all():
        fail("[cli] the merged leaf is not base + scale * a @ b of the checkpoint")
    del saved, a, b, want, got, diff, ulp

    # folder mode on the engine built above
    cwd = os.getcwd()
    os.chdir(work)
    try:
        with Swap(cli_common, build_engine=lambda **kw: engine):
            run_cli("cli folder", ["--tgt", folder, *argv])
    finally:
        os.chdir(cwd)
    with open(os.path.join(work, "results", "recognition.json"), encoding="utf-8") as f:
        records = json.load(f)
    if len(records) != 2 or any(r["response"] == "ERROR!" for r in records):
        fail(f"[cli folder] {len(records)} records, responses {[r['response'][:20] for r in records]}")

    # ---------------------------------------------------------- 18. beams, chat, stream_generate
    cfg = engine.cfg.llm
    L = cfg.num_hidden_layers
    page = make_page(3)[0]
    beams = []
    beam_generate = gen_mod.beam_generate_from_embeds

    def beam_and_keep(*a, **kw):
        out = beam_generate(*a, **kw)
        beams.append((out[0].cpu(), out[1].cpu()))
        return out

    def counted(label, fn):
        h.zero_counts()
        t0 = time.time()
        with ShapeLog(h.kernels) as shapes, CallCount(internlm2, ("prefill",)) as st, \
                Swap(gen_mod, beam_generate_from_embeds=beam_and_keep):
            result = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = h.read_counts()
        n_pre, n_dec = st.n["prefill"], h.decode_steps()
        if launches["flash_decode"] != L * n_dec or not n_dec:
            fail(f"[{label}] flash_decode launches {launches['flash_decode']} != {L} x {n_dec}")
        h.check_norms(label, launches, L, n_pre + n_dec)
        log(f"[{label}] {wall:.3f} s, {n_pre} prefill(s), {n_dec} decode steps "
            f"({wall / max(n_dec, 1) * 1e3:.3f} ms a step, prefill and page stages included), "
            f"flash_decode at B={shapes.calls['flash_decode'][-1][0][0]}; launches {launches}")
        return result, shapes, launches

    resp, shapes, launches = counted("beams", lambda: engine.chat_ocr(
        page, QUESTION, num_beams=4, max_new_tokens=128))
    tokens, lengths = beams[-1]
    if shapes.calls["flash_decode"][-1][0][0] != 4 or not 1 <= int(lengths[0]) <= 128:
        fail(f"[beams] decode batch {shapes.calls['flash_decode'][-1][0]}, best beam length "
             f"{int(lengths[0])}")
    log(f"[beams] best beam of 4: {int(lengths[0])} tokens, {resp[:30]!r}")
    h.keep_norms("beams", shapes, launches)
    h.flash_decode_row("beams", shapes, launches)
    resp, _, _ = counted("chat", lambda: engine.chat(page, QUESTION, max_new_tokens=128))
    log(f"[chat] {resp[:30]!r}")
    out = io.StringIO()
    (resp, hist), _, _ = counted("stream", lambda: chat_cli.stream_generate(
        engine, QUESTION, None, image=page, max_new_tokens=64, out=out))
    if len(hist) != 1 or hist[0][1] != resp or not out.getvalue().endswith("\n"):
        fail("[stream] stream_generate did not stream a whole turn")
    log(f"[stream] stream_generate: {len(out.getvalue())} characters streamed")

    # ---------------------------------------------------------- 18. the agent: chat --agent
    # the CLI in-process with its arguments and a scripted stdin (a question,
    # then EXIT), on this engine (the same preset and int8 LLM, phase 17's
    # adapter merged) in place of its own build
    turns, answers = [], []
    stream, agent_chat = chat_cli.stream_generate, agent_mod.ReActAgent.chat

    def counted_turn(*a, **kw):
        turns.append(kw.get("stop_words"))
        return stream(*a, **kw)

    def kept_answer(agent, question):
        answers.append(agent_chat(agent, question))
        return answers[-1]

    argv = ["--agent", "--preset", TRAIN_PRESET, "--random-init", "--quant", "int8",
            "--max-new-tokens", str(AGENT_TOKENS)]
    out = io.StringIO()
    h.zero_counts()
    t0 = time.time()
    with ShapeLog(h.kernels) as shapes, CallCount(internlm2, ("prefill",)) as st, \
            Swap(cli_common, build_engine=lambda **kw: engine), \
            Swap(chat_cli, stream_generate=counted_turn), \
            Swap(agent_mod.ReActAgent, chat=kept_answer), \
            Swap(sys, stdin=io.StringIO(AGENT_STDIN)), contextlib.redirect_stdout(out):
        chat_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = h.read_counts()
    n_pre, n_dec = st.n["prefill"], h.decode_steps()
    answer = answers[0] if len(answers) == 1 else None
    missing = [n for n in ("flash_attention", "flash_decode", "int8_matmul", "int8_matmul_nt",
                           "rms_norm_fwd") if not launches[n]]
    if not turns or any(w != ("Response:",) for w in turns) or n_pre != len(turns) or missing \
            or launches["flash_decode"] != L * n_dec or launches["int8_matmul"] != 4 * L * n_dec \
            or launches["int8_matmul_nt"] != n_pre + n_dec or not isinstance(answer, str) \
            or answer + "\n" not in out.getvalue():
        fail(f"[agent] {len(turns)} turns (stop words {turns}), {n_pre} prefills, {n_dec} decode "
             f"steps; launches {launches}; never launched {missing}; answers {answers}")
    h.check_norms("agent", launches, L, n_pre + n_dec)
    log(f"[agent] chat --agent: {len(turns)} stream_generate turn(s) stopping at 'Response:', "
        f"{n_dec} decode steps in {wall:.3f} s ({wall / max(n_dec, 1) * 1e3:.3f} ms a step, "
        f"prefills included); answer {answer[:40]!r}; launches {launches}")
    h.keep_norms("agent", shapes, launches)
    h.flash_decode_row("agent", shapes, launches)


def eval_tasks():
    """Phase 23's synthetic CalliBench tasks in memory, in the layout the
    harness reads: {path under EVAL_DATA: (images, annotations)}, the mmbench
    rows and the refcoco samples. Pages are the bench's seeded 788x2000 pages,
    their "text" a char of TRAIN_TEXT a box."""
    rng = np.random.RandomState(23)
    pages_boxes = [make_page(seed) for seed in range(EVAL_PAGES)]
    pages = [p for p, _ in pages_boxes]
    texts = ["".join(rng.choice(list(TRAIN_TEXT), len(b))) for _, b in pages_boxes]
    at = functools.partial(os.path.join, EVAL_DATA)
    (x1, y1), (x2, y2) = EVAL_REGION
    region_text = ["".join(ch for ch, b in zip(t, pb[1])
                           if x1 <= (b[0] + b[2]) / 2 < x2 and y1 <= (b[1] + b[3]) / 2 < y2)
                   for t, pb in zip(texts, pages_boxes)]
    options = "\nA: 王羲之\nB: 颜真卿\nC: 柳公权"
    n = EVAL_TWO_TURN
    works = [np.ascontiguousarray(p[:EVAL_WORK_ROWS]) for p in pages[:3 * n]]

    def conv(question, answer):
        return [{"from": "human", "value": question}, {"from": "gpt", "value": answer}]

    tasks = {
        at("full_page_ocr/easy/easy.parquet"): (pages, [
            {"imagePath": f"page{i}.jpg", "reference": t} for i, t in enumerate(texts)]),
        at("region-wise/region.parquet"): (pages[:EVAL_REGIONS], [
            {"imagePath": f"page{i}.jpg", "answer": region_text[i], "region": [list(EVAL_REGION[0]),
                                                                                list(EVAL_REGION[1])]}
            for i in range(EVAL_REGIONS)]),
        at("choice/author/author.parquet"): (works[:n], [
            {"image": f"page{i}.jpg", "conversations": conv(
                "<image>\n这幅书法作品的作者是谁？" + options, "ABC"[i % 3])} for i in range(n)]),
        at("reasoning/bilingual/medium/bilingual_medium.parquet"): (works[n:2 * n], [
            {"image": f"page{i}.jpg", "conversations": conv(
                "请将这幅书法作品的内容译成英文。\nA: 是\nB: 否", f"The text reads {texts[i][:8]}.")}
            for i in range(n, 2 * n)]),
        at("reasoning/intent/intent.parquet"): (works[2 * n:3 * n], [
            {"image": f"page{i}.jpg", "content": texts[i], "conversations": conv(
                "请分析这幅书法作品的创作意图。", "借物抒怀，寄托思乡之情。")}
            for i in range(2 * n, 3 * n)]),
    }
    mm_rows = [{"index": str(i), "question": "图中是什么？", "hint": "nan", "A": "书法", "B": "山水画",
                "C": "花鸟画", "D": "人物画", "answer": "A",
                "_image": np.ascontiguousarray(pages[i][400:848, 170:618])}
               for i in range(EVAL_MMBENCH)]
    ref_samples = [{"image": np.ascontiguousarray(pages[i][:480, 148:788]), "sents": "右上角的字",
                    "bbox": [500, 40, 80, 80], "height": 480, "width": 640}
                   for i in range(EVAL_REFCOCO)]
    return tasks, mm_rows, ref_samples


class TileMemo:
    """preprocess.load_image keeping each page's tiles (keyed by its bytes
    and the arguments): a page tiled again takes a copy of its first tiling
    (the host tiling is deterministic numpy, ~1.1 s a 788x2000 page), and a
    page tiled ahead (``put``) takes those tiles."""

    def __init__(self, load_image):
        self.load_image, self.cache, self.hits = load_image, {}, 0

    @staticmethod
    def key(img, a, kw):
        return (img.shape, img.dtype.str, hashlib.sha1(img).hexdigest(), a, tuple(sorted(kw.items())))

    def put(self, img, a, tiles):
        self.cache[self.key(np.ascontiguousarray(img), a, {})] = tiles

    def __call__(self, img, *a, **kw):
        img = np.ascontiguousarray(img)
        key = self.key(img, a, kw)
        if key in self.cache:
            self.hits += 1
        else:
            self.cache[key] = self.load_image(img, *a, **kw)
        return self.cache[key].copy()


def tile_args():
    """The host tiling's arguments on phase 23's engine (the 2b preset)."""
    from callireader_tpu_torch.core.config import get_config

    cfg = get_config("callireader-2b")
    return cfg.force_image_size, cfg.max_dynamic_patch, cfg.use_thumbnail


def tile_eval_pages(seeds):
    """In a worker process: the host tiles of phase 23's pages of ``seeds``
    and the seconds it took."""
    from callireader_tpu_torch.vision import preprocess

    t0 = time.time()
    return [preprocess.load_image(make_page(s)[0], *tile_args()) for s in seeds], time.time() - t0


def tile_ahead():
    """Phase 23's 16 pages tiled on the host in two worker processes while
    the device-bound phases 24 and 17-18 run -> (the pool, its futures)."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn"))
    seeds = list(range(EVAL_PAGES))
    return pool, [pool.submit(tile_eval_pages, seeds[i::2]) for i in range(2)]


def evaluate_phase(h, ahead):
    """Phase 23: the evaluation harness. cli.evaluate.main runs full_page at
    its defaults (RGB chars resized on the host by the native library, host
    tiling, batch 8) on ``--preset callireader-2b --random-init --quant
    int8``, its parquet reader swapped for the in-memory tasks, its pages'
    tiles made ahead (``tile_ahead``: the full_page run reads them); the
    engine it built then runs region_wise, choice, bilingual, intent,
    mmbench and refcoco -> (the full_page run's raw char crops, the engine's
    char content size, its char_prep seconds) for phase 25."""
    import torch

    from callireader_tpu_torch.cli import common as cli_common
    from callireader_tpu_torch.cli import evaluate as eval_cli
    from callireader_tpu_torch.evalx import callibench, mmbench, refcoco
    from callireader_tpu_torch.evalx.metrics import t2s
    from callireader_tpu_torch.models import internlm2
    from callireader_tpu_torch.runtime import engine as engine_mod
    from callireader_tpu_torch.runtime.engine import CalliReaderEngine
    from callireader_tpu_torch.utils.profiling import SPANS
    from callireader_tpu_torch.vision import preprocess

    tasks, mm_rows, ref_samples = eval_tasks()
    work = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    save = os.path.join(work, "outputs", "eval")
    built, seconds, run = [], {}, {}
    build = cli_common.build_engine

    def keep(**kw):
        built.append(build(**kw))
        return built[-1]

    routes = {"raw_groups": 0, "raw": 0, "host": [], "crops": []}
    raw_groups, raw, host, host_groups = (
        CalliReaderEngine._prep_char_raw_groups, CalliReaderEngine._char_pipeline_raw,
        CalliReaderEngine._char_pipeline, CalliReaderEngine._prep_char_crop_groups)

    def record_crops(self, raw_crops):
        routes["crops"].extend(raw_crops)
        return host_groups(self, raw_crops)

    def count_raw_groups(self, *a, **kw):
        routes["raw_groups"] += 1
        return raw_groups(self, *a, **kw)

    def count_raw(self, *a, **kw):
        routes["raw"] += 1
        return raw(self, *a, **kw)

    def record_host(self, content, *a, **kw):
        routes["host"].append(tuple(content.shape))
        return host(self, content, *a, **kw)

    test_full_page = callibench.test_full_page

    def counted_full_page(*a, **kw):
        """The CLI's full_page run, the counts zeroed just before, read just
        after."""
        run["kw"] = kw
        h.zero_counts()
        t0 = time.time()
        with ShapeLog(h.kernels) as shapes, CallCount(internlm2, ("prefill",)) as pre:
            out = test_full_page(*a, **kw)
        torch.cuda.synchronize()
        seconds["full_page"] = time.time() - t0
        run.update(shapes=shapes, launches=h.read_counts(), n_pre=pre.n["prefill"],
                   n_dec=h.decode_steps())
        return out

    def timed(name, fn, *a, **kw):
        t0 = time.time()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        seconds[name] = time.time() - t0
        return out

    cwd = os.getcwd()
    os.chdir(work)
    # a page the phase tiles again (batch_chat_ocr after the full_page run, a
    # two-turn task's second turn) takes the tiles of its first tiling
    tiles = TileMemo(preprocess.load_image)
    pool, futures = ahead
    t0 = time.time()
    tiled = [f.result() for f in futures]
    pool.shutdown()
    wait_s = time.time() - t0
    full_pages = tasks[os.path.join(EVAL_DATA, "full_page_ocr/easy/easy.parquet")][0]
    for i, (page_tiles, _) in enumerate(tiled):
        for seed, t in zip(range(i, EVAL_PAGES, 2), page_tiles):
            tiles.put(full_pages[seed], tile_args(), t)
    log(f"[evaluate] the {EVAL_PAGES} pages' host tiles made ahead in 2 worker processes "
        f"({' + '.join(f'{s:.3f}' for _, s in tiled)} s of tiling, the workers' own clocks) while "
        f"phases 24 and 17-18 ran; {wait_s:.3f} s waited for them here")
    memo = Swap(preprocess, load_image=tiles)
    memo.__enter__()
    try:
        argv = ["--type", "full_page", "--splits", "easy", "--data", EVAL_DATA, "--preset",
                "callireader-2b", "--random-init", "--quant", "int8", "--save_name", "eval"]
        t0 = time.time()
        with Swap(cli_common, build_engine=keep), \
                Swap(callibench, get_parquet=lambda path: tasks[path],
                     test_full_page=counted_full_page), \
                Swap(CalliReaderEngine, _prep_char_raw_groups=count_raw_groups,
                     _char_pipeline_raw=count_raw, _char_pipeline=record_host,
                     _prep_char_crop_groups=record_crops):
            eval_cli.main(argv)
        seconds["cli"] = time.time() - t0
        (engine,) = built
        cfg = engine.cfg
        L = cfg.llm.num_hidden_layers
        launches, shapes, n_pre, n_dec = run["launches"], run["shapes"], run["n_pre"], run["n_dec"]
        log(f"[evaluate] cli.evaluate full_page: {EVAL_PAGES} pages in {seconds['full_page']:.3f} s "
            f"({EVAL_PAGES / seconds['full_page']:.4f} pages/s pipelined, batch "
            f"{run['kw']['batch_size']}), {seconds['cli']:.3f} s with the engine build; engine "
            f"options gray_chars={engine.gray_chars} device_resize_chars={engine.device_resize_chars} "
            f"device_tile_pages={engine.device_tile_pages}; {n_pre} prefills, {n_dec} decode steps "
            f"({engine_mod.DECODE_PAD_STEPS.launches} pad steps); spans (s) "
            + json.dumps({k: round(v, 4) for k, v in SPANS.totals.items()})
            + f"; launches {launches}")
        char_crops_s = SPANS.totals["char_prep"]
        if (engine.gray_chars, engine.device_resize_chars, engine.device_tile_pages) != \
                (False, False, False) or run["kw"]["batch_size"] != 8:
            fail("[evaluate] the CLI's engine left the harness's defaults (RGB chars, host char "
                 "resize, host tiling, batch 8)")
        path = ("vit_attention", "flash_attention", "flash_decode", "int8_matmul", "int8_matmul_nt",
                "rms_norm_fwd")
        char_calls = [a for a in shapes.calls["vit_attention"]
                      if a[0][-1] // 3 // a[1] != cfg.vision.head_dim]
        tile_calls = len(shapes.calls["vit_attention"]) - len(char_calls)
        missing = [n for n in path if launches[n] == 0]
        if missing or not char_calls or not tile_calls:
            fail(f"[evaluate] kernels never launched: {missing}; char tower calls {len(char_calls)}, "
                 f"tile tower calls {tile_calls}")
        if n_pre != 2 or launches["flash_decode"] != L * n_dec \
                or launches["int8_matmul"] != 4 * L * n_dec \
                or launches["int8_matmul_nt"] != n_dec + n_pre:
            fail(f"[evaluate] launches {launches} for {n_pre} prefills (want 2) and {n_dec} decode "
                 f"steps")
        h.check_norms("evaluate", launches, L, n_pre + n_dec)
        if routes["raw_groups"] or routes["raw"] or not routes["host"] \
                or any(len(s) != 4 or s[-1] != 3 for s in routes["host"]):
            fail(f"[evaluate] the char crops left the RGB host route: {routes['raw_groups']} raw "
                 f"group preps, {routes['raw']} raw dispatches, host canvases {routes['host']}")
        log(f"[evaluate] char crops: {len(routes['host'])} RGB host canvas stacks "
            f"{sorted(set(routes['host']))}, no raw device group; tile tower calls {tile_calls}, "
            f"char tower calls {len(char_calls)}")

        with open(os.path.join(save, "full_page_easy.json"), encoding="utf-8") as f:
            full = json.load(f)
        responses = [d["output"] for d in full["detailed"]]
        opts = {k: run["kw"][k] for k in ("use_p", "hard_vq", "drop_zero", "repetition_penalty")}
        pages = tasks[os.path.join(EVAL_DATA, "full_page_ocr/easy/easy.parquet")][0]
        direct = timed("batch_chat_ocr", engine.batch_chat_ocr, pages[:8],
                       [callibench.FULL_PAGE_PROMPT] * 8, **opts)
        if [t2s(r) for r in direct] != responses[:8]:
            fail("[evaluate] the pipelined responses differ from batch_chat_ocr on the same 8 pages")
        log(f"[evaluate] pipelined responses = batch_chat_ocr on the same 8 pages; pages/s: "
            f"pipelined {EVAL_PAGES / seconds['full_page']:.4f} ({EVAL_PAGES} pages, 2 batches), "
            f"batch_chat_ocr {8 / seconds['batch_chat_ocr']:.4f} (8 pages, one batch, after, on "
            f"the tiles made ahead)")

        # ---------------------------------------------------------- the other tasks, same engine
        kw = dict(run["kw"])
        with Swap(callibench, get_parquet=lambda path: tasks[path]):
            at = functools.partial(os.path.join, EVAL_DATA)
            region = timed("region_wise", callibench.test_region_wise, engine,
                           at("region-wise/region.parquet"), os.path.join(save, "region_wise.json"),
                           **kw)
            h.zero_counts()
            with ShapeLog(h.kernels) as choice_shapes:
                _, choice = timed("choice", callibench.test_choice, engine,
                                  at("choice/author/author.parquet"),
                                  os.path.join(save, "author.json"), limit=EVAL_TWO_TURN, **kw)
            choice_launches = h.read_counts()
            bil = timed("bilingual", callibench.test_bilingual, engine,
                        at("reasoning/bilingual/medium/bilingual_medium.parquet"),
                        os.path.join(save, "bilingual.json"), **kw)
            intent = timed("intent", callibench.test_intent, engine,
                           at("reasoning/intent/intent.parquet"), os.path.join(save, "intent.json"),
                           **kw)
        with Swap(mmbench, load_tsv=lambda path: mm_rows):
            mm = timed("mmbench", mmbench.evaluate_mmbench, engine, "mmbench.tsv",
                       os.path.join(save, "mmbench.xlsx"))
        ref = timed("refcoco", refcoco.evaluate_refcoco, engine, ref_samples)
        with open(os.path.join(save, "refcoco.json"), "w") as f:
            json.dump({"accuracy": ref["accuracy"]}, f)

        layout = {
            "full_page_easy.json": (EVAL_PAGES, {"imgPath", "prompt", "output", "gt", "precision",
                                                 "recall", "f1", "ned"}),
            "region_wise.json": (EVAL_REGIONS, {"imgPath", "prompt", "output", "gt", "precision",
                                                "recall", "f1", "ned"}),
            "author.json": (EVAL_TWO_TURN, {"imgPath", "output", "reference"}),
            "bilingual.json": (EVAL_TWO_TURN, {"imgPath", "chinese", "answer", "gt"}),
            "intent.json": (EVAL_TWO_TURN, {"imgPath", "chinese", "answer", "gt",
                                            "calligraphy_content"}),
            "mmbench.xlsx": (EVAL_MMBENCH, {"index", "question", "prediction", "pred_option",
                                            "answer"}),
        }
        tops = {"full_page_easy.json": {"detailed", "average"}, "region_wise.json": {"detailed", "average"},
                "author.json": {"detailed", "summary"}, "bilingual.json": {"detailed"},
                "intent.json": {"detailed"}, "mmbench.xlsx": {"detailed", "accuracy", "scored", "total"}}
        text_keys = ("output", "chinese", "answer", "prediction")
        for name, (count, keys) in layout.items():
            with open(os.path.join(save, name), encoding="utf-8") as f:
                res = json.load(f)
            recs = res["detailed"]
            if set(res) != tops[name] or len(recs) != count or any(set(r) != keys for r in recs) \
                    or not all(isinstance(r[k], str) for r in recs for k in text_keys if k in r):
                fail(f"[evaluate] {name}: keys {sorted(res)}, {len(recs)} records (want {count}), "
                     f"record keys {sorted(recs[0]) if recs else None}")
        with open(os.path.join(save, "refcoco.json")) as f:
            if set(json.load(f)) != {"accuracy"} or len(ref["detailed"]) != EVAL_REFCOCO \
                    or not all(isinstance(a["ans"], str) for a in ref["detailed"]):
                fail("[evaluate] refcoco.json or its answers")
        if choice["summary"]["total_samples"] != EVAL_TWO_TURN or mm["total"] != EVAL_MMBENCH:
            fail("[evaluate] the choice or mmbench counts")
        log(f"[evaluate] seconds per task: " + json.dumps({k: round(v, 3) for k, v in seconds.items()})
            + f"; F1 full page {full['average']['avg_f1']:.4f}, region {region['average']['avg_f1']:.4f}; "
            f"choice accuracy {choice['summary']['accuracy']}; mmbench {mm['accuracy']}; refcoco "
            f"{ref['accuracy']}; bilingual / intent answers of {[len(d['answer']) for d in bil['detailed']]}"
            f" / {[len(d['answer']) for d in intent['detailed']]} chars; files "
            f"{sorted(os.listdir(save))} (random weights: the scores are noise)")

        # the towers at the full_page run's batches (the char tower on the RGB
        # host canvases), the two-turn prefill at the choice task's longest
        # prompt, flash_decode at its batch
        h.vit_rows("evaluate", shapes, launches)
        calls = choice_shapes.calls["flash_attention"]
        longest = max(calls, key=lambda c: c[0][2])
        at_longest = [c for c in calls if c[:2] == longest[:2]]
        log(f"[evaluate] choice: prefill shapes {sorted({c[0] for c in calls})}, decode at "
            f"B={choice_shapes.calls['flash_decode'][-1][0][0]}")
        h.flash_attention_rows("evaluate choice, turn 2",
                               types.SimpleNamespace(calls={"flash_attention": at_longest}),
                               {"flash_attention": len(at_longest)})
        h.flash_decode_row("evaluate choice", choice_shapes, choice_launches)

        # the harness's RGB host route against the default luma device route,
        # and each of the two differences alone (printed, not checked: JAX
        # calls the routes near- but not bit-identical)
        page = pages[0]
        ordered = engine.batch_sort_boxes([page])
        by_route = {}
        try:
            for gray in (False, True):
                for device_resize in (False, True):
                    engine.gray_chars, engine.device_resize_chars = gray, device_resize
                    by_route[("luma" if gray else "RGB") + (" device" if device_resize else " host")] = \
                        engine.batch_calli_align([page], ordered_lists=ordered)[0]
        finally:
            engine.gray_chars = engine.device_resize_chars = False

        def agree(a, b):
            (pa, ia), (pb, ib) = by_route[a], by_route[b]
            cos = torch.nn.functional.cosine_similarity(pa.float(), pb.float(), dim=-1)
            return (f"{a} / {b}: {(ia == ib).float().mean().item():.4f} of the VQ indices equal, "
                    f"pseudo rows' cosine min {cos.min().item():.6f} mean {cos.mean().item():.6f}")

        log(f"[evaluate] page 0's {by_route['RGB host'][1].shape[0]} crops by char route: "
            + "; ".join(agree(a, b) for a, b in (("RGB host", "luma device"), ("RGB host", "RGB device"),
                                                  ("RGB host", "luma host"),
                                                  ("luma host", "luma device"))))
        log(f"[evaluate] host tiling: {len(tiles.cache)} pages tiled, {tiles.hits} tilings taken "
            f"from those made ahead or before")
    finally:
        memo.__exit__()
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    return routes["crops"], engine.char_content_size, char_crops_s


def bits(t):
    """A tensor's bits as integers of its width (torch.equal on floats takes
    -0.0 for 0.0 and fails on NaN)."""
    import torch

    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(width[t.element_size()])


def tree_diff(got, want, cast_ok=()):
    """The leaves of two trees that differ in name, shape, dtype or bits;
    a leaf under a prefix in ``cast_ok`` may differ in dtype and is compared
    in ``want``'s."""
    import torch

    from callireader_tpu_torch.train.e_it import flatten

    fg, fw = flatten(got), flatten(want)
    bad = sorted(set(fg) ^ set(fw))
    for k in set(fg) & set(fw):
        g, w = fg[k], fw[k]
        if g.dtype != w.dtype and k.startswith(cast_ok):
            g = g.to(w.dtype)
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(bits(g), bits(w)):
            bad.append(k)
    return bad, len(fw)


class SideFilesRead:
    """``torch`` for train/checkpoint.py's export, whose ``save`` writes only
    the side files a boot reads (converted to host fp32 there, as the export
    converts them) and skips the others, which nothing of the boot opens."""

    def __init__(self, torch, host32, names):
        self._torch, self._host32, self._names = torch, host32, names
        self.written, self.skipped = [], []

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def save(self, obj, path, *a, **kw):
        name = os.path.basename(path)
        if name not in self._names:
            self.skipped.append(name)
            return None
        self.written.append(name)
        return self._torch.save(self._host32(obj), path, *a, **kw)


def boot_phase(h, run_main_path, path_2b):
    """Phase 22: the reference-checkpoint boot at callireader-2b: the engine
    drawn without trained assets, exported in the reference layout, booted
    by cli.common.build_engine and by cli.inference (int8) from the
    directory; leaves and token ids against the in-memory tree."""
    import torch

    from callireader_tpu_torch.cli import common as cli_common
    from callireader_tpu_torch.cli import inference as inf_cli
    from callireader_tpu_torch.models import internlm2
    from callireader_tpu_torch.runtime import engine as engine_mod
    from callireader_tpu_torch.runtime import generate as gen_mod
    from callireader_tpu_torch.train import checkpoint as ckpt_mod
    from callireader_tpu_torch.train import e_it

    work = tempfile.mkdtemp(prefix="chip_smoke_boot_")
    try:
        mem = engine_mod.build_engine(BOOT_PRESET, device=h.dev, assets=(), device_tile_pages=True)
        ckpt = os.path.join(work, "InternVL")
        free = shutil.disk_usage(work).free
        shards_s = []
        export_shards = ckpt_mod.export_reference_format

        def timed_shards(*a, **kw):
            t0 = time.time()
            out = export_shards(*a, **kw)
            shards_s.append(time.time() - t0)
            return out

        t0 = time.time()
        side = SideFilesRead(torch, ckpt_mod._host32, BOOT_SIDE_READ)
        with Swap(ckpt_mod, export_reference_format=timed_shards, torch=side,
                  _host32=lambda tree: tree):
            ckpt_mod.export_full_reference_checkpoint(mem.params, mem.cfg, ckpt,
                                                      max_shard_bytes=BOOT_SHARD)
        export_s = time.time() - t0
        if sorted(side.written) != sorted(BOOT_SIDE_READ):
            fail(f"[boot] side files written {side.written}, want {BOOT_SIDE_READ}")
        files = {os.path.relpath(os.path.join(r, f), ckpt): os.path.getsize(os.path.join(r, f))
                 for r, _, fs in os.walk(ckpt) for f in fs}
        shards = [f for f in files if f.endswith(".safetensors")]
        shard_bytes = sum(files[f] for f in shards)
        # the phase's own count: every exported float in fp32, and the headers
        floats = sum(t.numel() for name in ("llm", "vision", "projector", "resampler")
                     for t in e_it.flatten(mem.params[name]).values())
        floats += mem.params["align"]["normed_emb"].numel()
        if not 4 * floats <= shard_bytes <= 4 * floats + (1 << 20):
            fail(f"[boot] {shard_bytes} bytes of shards for {floats} exported floats")
        read_bytes = shard_bytes + sum(files[os.path.join("params", f)] for f in BOOT_SIDE_READ)
        log(f"[boot] export_full_reference_checkpoint of the {BOOT_PRESET} engine (no trained "
            f"assets): {sum(files.values()) / 1e9:.3f} GB in {len(files)} files "
            f"({shard_bytes / 1e9:.3f} GB of fp32 in {len(shards)} shards of at most "
            f"{BOOT_SHARD / 2**30:.0f} GiB, the tree's {floats} floats and the headers; "
            f"{(sum(files.values()) - shard_bytes) / 1e9:.3f} GB of side files: the ones the boot "
            f"reads, {side.skipped} not written), "
            f"{free / 1e9:.1f} GB free before; {export_s:.3f} s to return "
            f"({sum(files.values()) / export_s / 1e9:.3f} GB/s: the shards {shards_s[0]:.3f} s, "
            f"{shard_bytes / shards_s[0] / 1e9:.3f} GB/s; the side files' torch.save "
            f"{export_s - shards_s[0]:.3f} s); no os.sync: the boot reads the page cache")

        # ------------------------------------------ build_engine(checkpoint_dir=...), bf16
        t0 = time.time()
        disk = cli_common.build_engine(preset=BOOT_PRESET, checkpoint_dir=ckpt,
                                       trained_assets=False, device=h.dev)
        torch.cuda.synchronize()
        boot_s = time.time() - t0
        # the loader casts every leaf but the detector's and the OrderFormer's
        # to bf16, mu and sigma too (the JAX loader's rule): those two are
        # compared in the in-memory fp32
        bad, n_leaves = tree_diff(disk.params, mem.params, cast_ok=("align/mu", "align/sigma"))
        log(f"[boot] cli.common.build_engine(checkpoint_dir=...) in {boot_s:.3f} s: "
            f"{read_bytes / 1e9:.3f} GB read (the shards and the three side files it reads, "
            f"partly from the page cache) at {read_bytes / boot_s / 1e9:.3f} GB/s; components "
            f"drawn at random {disk.random_components}; {n_leaves - len(bad)} of {n_leaves} "
            f"leaves bit-equal to the in-memory tree")
        if bad or disk.random_components or disk.assets:
            fail(f"[boot] leaves that differ from the in-memory tree: {bad[:8]}; random "
                 f"{disk.random_components}, assets {disk.assets}")
        run = run_main_path(disk, MAX_NEW_TOKENS, "boot", compact=False)
        missing = [n for n in path_2b if run.launches[n] == 0]
        if missing:
            fail(f"[boot] kernels never launched on the booted engine's path: {missing}")
        prep = mem.batch_prepare([make_page(seed)[0] for seed in range(N_PAGES)],
                                 [QUESTION] * N_PAGES, max_new_tokens=MAX_NEW_TOKENS,
                                 repetition_penalty=1.5, ordered_lists=run.ordered)
        mem.batch_decode(prep)
        if not (torch.equal(prep["tokens"], run.prepared["tokens"])
                and torch.equal(prep["lengths"], run.prepared["lengths"])):
            fail(f"[boot] the booted engine's token ids differ from the in-memory engine's "
                 f"(lengths {run.prepared['lengths'].tolist()} against {prep['lengths'].tolist()})")
        log(f"[boot] batch_chat_ocr of the booted engine = the in-memory engine's: {N_PAGES} rows "
            f"x {MAX_NEW_TOKENS} token ids equal")
        h.attention_rows("boot", run.shapes, run.launches)
        del disk, run, prep
        torch.cuda.empty_cache()

        # ------------------------------------------ cli.inference --checkpoint --quant int8
        page_path = os.path.join(work, "page.npy")
        np.save(page_path, make_page(0)[0])
        kept, gens = {}, []
        build_cli, generate = cli_common.build_engine, gen_mod.generate_from_embeds

        def cli_and_keep(**kw):
            t0 = time.time()
            kept["engine"] = build_cli(**kw)
            torch.cuda.synchronize()
            kept["build_s"] = time.time() - t0
            return kept["engine"]

        def generate_and_keep(*a, **kw):
            out = generate(*a, **kw)
            gens.append((out[0].cpu(), out[1].cpu()))
            return out

        argv = ["--tgt", page_path, "--preset", BOOT_PRESET, "--checkpoint", ckpt, "--quant",
                "int8", "--no-trained-assets", "--device", h.dev.type]
        h.zero_counts()
        out = io.StringIO()
        t0 = time.time()
        with ShapeLog(h.kernels) as shapes, CallCount(internlm2, ("prefill",)) as steps, \
                Swap(cli_common, build_engine=cli_and_keep), \
                Swap(gen_mod, generate_from_embeds=generate_and_keep), \
                contextlib.redirect_stdout(out):
            inf_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = h.read_counts()
        cli_engine, cli_gens = kept["engine"], list(gens)
        L = cli_engine.cfg.llm.num_hidden_layers
        n_pre, n_dec = steps.n["prefill"], h.decode_steps()
        missing = [n for n in path_2b + ("int8_matmul", "int8_matmul_nt") if launches[n] == 0]
        if missing or launches["flash_decode"] != L * n_dec \
                or launches["int8_matmul"] != 4 * L * n_dec \
                or launches["int8_matmul_nt"] != n_dec + n_pre:
            fail(f"[boot cli] launches {launches} for {n_pre} prefills and {n_dec} decode steps; "
                 f"never launched: {missing}")
        h.check_norms("boot cli", launches, L, n_pre + n_dec)
        # the in-memory tree through build_engine's int8 order: quantize, pad
        # the vocab to 128, fuse
        ref_params, ref_cfg = cli_common.quantize_params(dict(mem.params), mem.cfg, "int8")
        bad, n_leaves = tree_diff(cli_engine.params["llm"], ref_params["llm"])
        if bad or cli_engine.cfg != ref_cfg:
            fail(f"[boot cli] int8 leaves that differ from the in-memory tree quantized, padded "
                 f"and fused: {bad[:8]}; cfg equal {cli_engine.cfg == ref_cfg}")
        ref = engine_mod.CalliReaderEngine(ref_cfg, ref_params, mem.tok, device=h.dev,
                                           device_tile_pages=True)
        gens.clear()
        with Swap(cli_common, build_engine=lambda **kw: ref), \
                Swap(gen_mod, generate_from_embeds=generate_and_keep), \
                contextlib.redirect_stdout(io.StringIO()):
            inf_cli.main(argv)
        if len(gens) != len(cli_gens) or not all(
                torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(gens, cli_gens)):
            fail("[boot cli] the CLI's token ids differ from those of the in-memory tree's int8 "
                 "engine")
        log(f"[boot cli] cli.inference --checkpoint --quant int8 --no-trained-assets on one page: "
            f"{wall:.3f} s wall, the engine (boot + int8) in {kept['build_s']:.3f} s; "
            f"{n_leaves} int8 LLM leaves bit-equal to the in-memory tree quantized, padded and "
            f"fused; {n_pre} prompt(s), {[int(n[0]) for _, n in cli_gens]} new tokens, token ids "
            f"equal to that engine's; launches {launches}; printed "
            f"{[ln[:40] for ln in out.getvalue().splitlines()[:2]]}")
        h.flash_decode_row("boot cli", shapes, launches)
        log(f"[boot] card: {h.smi}; export {export_s:.3f} s for "
            f"{sum(files.values())} bytes in {len(files)} files ({len(shards)} shards); boot "
            f"{boot_s:.3f} s for {read_bytes} bytes read, {read_bytes / boot_s / 1e9:.3f} GB/s "
            f"(host and disk times of the card's machine, not kernel times)")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def bench_phase(h, engine, batch_path):
    """Phase 20: the port's bench row code in-process on the 8b int8 engine
    (callireader_tpu_torch/bench.py's detector rule and measure(): the
    warm-up batch, 2 TTFT samples, one warm and 3 steady pipelined intervals
    of 8 pages x 256 tokens), every count zeroed just before and read just
    after."""
    import torch

    from callireader_tpu_torch import bench
    from callireader_tpu_torch.models import internlm2
    from callireader_tpu_torch.runtime import engine as engine_mod
    from callireader_tpu_torch.utils.profiling import SPANS

    page, gt = bench.make_page()
    saved = engine.detector, engine.params["detector"]
    det_mode = bench.choose_detector(engine, page, gt, smoke=False, gt_boxes=False)
    n_chars = len(engine.sort_boxes(page)) if det_mode == "trained_ckpt" else len(gt)
    # one warm interval (the first after the primed batch), then 3 measured
    protocol = bench.Protocol(batch=8, n_batches=BENCH_SHORT_BATCHES, n_ttft=2,
                              max_warm_batches=1)
    SPANS.reset()
    h.zero_counts()
    t0 = time.time()
    with ShapeLog(h.kernels) as shapes, CallCount(internlm2, ("prefill",)) as st:
        run = bench.measure(engine, page, protocol, n_chars=n_chars)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = h.read_counts()
    engine.detector, engine.params["detector"] = saved
    L = engine.cfg.llm.num_hidden_layers
    n_pre, n_dec = st.n["prefill"], h.decode_steps()
    # every batch decodes 256 tokens (measure() checks each batch's lengths):
    # the warm-up, the primed batch and the warm and measured intervals'
    # launches, 256 decode steps each; prefills: those batches' and the 4
    # TTFT calls'
    n_batches = 2 + 1 + BENCH_SHORT_BATCHES - 1
    if run.n_decodes != n_batches or n_dec != n_batches * protocol.decode_tokens \
            or n_pre != n_batches + 2 + protocol.n_ttft:
        fail(f"[bench] {run.n_decodes} batches, {n_pre} prefills and {n_dec} decode steps; "
             f"expected {n_batches}, {n_batches + 2 + protocol.n_ttft} and {n_batches} x "
             f"{protocol.decode_tokens}")
    missing = [n for n in batch_path if launches[n] == 0]
    if missing:
        fail(f"[bench] kernels never launched on the bench path: {missing}; {launches}")
    if launches["flash_decode"] != L * n_dec or launches["int8_matmul"] != 4 * L * n_dec \
            or launches["int8_matmul_nt"] != n_dec + n_pre:
        fail(f"[bench] launches {launches} for {n_pre} prefills and {n_dec} decode steps")
    h.check_norms("bench", launches, L, n_pre + n_dec)
    if run.phased_boxes != run.fused_boxes:
        fail("[bench] the phased box stages and batch_sort_boxes gave other boxes")
    result = dict(run.result)
    n_tiles = result.pop("tiles_per_image")
    result["workload"] = {"batch": 8, "preset": "callireader-8b", "llm_layers": L, "quant": "int8",
                          "page": "synthetic_clone", "detector": det_mode,
                          "chars_per_image": n_chars, "tiles_per_image": n_tiles,
                          "char_canvas": engine.char_canvas,
                          "decode_tokens": protocol.decode_tokens,
                          "stages": bench.STAGES, "device": bench.card_description()}
    line = bench.combined_line({"flagship_8b_int8": result}, ["flagship_8b_int8"])
    if len(json.dumps(result, ensure_ascii=False)) >= 2000 or len(line) >= 2000 \
            or json.loads(line)["value"] != result["value"]:
        fail(f"[bench] the row's line ({len(json.dumps(result))}) or the combined line "
             f"({len(line)}) is not a short JSON line")
    log(f"[bench] short run on the 8b int8 engine, {wall:.1f} s: detector {det_mode}, "
        f"{n_chars} chars, {n_tiles} tiles a page; phased boxes equal batch_sort_boxes' "
        f"({sum(len(b) for b in run.phased_boxes)} boxes over 8 pages); {n_batches} batches x 8 rows "
        f"x {protocol.decode_tokens} tokens; {json.dumps(result)}")
    log(f"[bench] combined line ({len(line)} characters): {line}")
    log(f"[bench] device wait inside an interval (the decode the host's work did not hide): "
        f"median {result['device_wait_s']} s of {result['batches']} s intervals; "
        f"pad steps {engine_mod.DECODE_PAD_STEPS.launches}")
    h.flash_decode_row("bench", shapes, launches)


def w8a8_phase(h, engine):
    """Phase 21: the W8A8 tile tower (``--quant int8-all``) on one page's
    tiles and the shared char tower at the 448 canvas on the page's crops,
    against the bf16 towers on the same inputs; the int32 sums of each of
    the first layer's four products against an exact (fp64) product on a
    slice of rows; the ViT kernel at both towers' shapes."""
    import torch

    from callireader_tpu_torch.models import internvit
    from callireader_tpu_torch.runtime.engine import CalliReaderEngine
    from callireader_tpu_torch.runtime.quantize import quantize_vit_int8
    from callireader_tpu_torch.vision import preprocess
    from callireader_tpu_torch.vision.device_resize import bicubic_canvas

    cfg = engine.cfg
    vit, proj = engine.params["vision"], engine.params["projector"]
    vit8 = quantize_vit_int8(vit)
    page, boxes = make_page(0)
    tiles = engine._to_dev(preprocess.load_image(page, cfg.force_image_size, cfg.max_dynamic_patch,
                                                 cfg.use_thumbnail))
    # the shared tower's char canvases: the engine's raw-crop route at 448
    shared = CalliReaderEngine(dataclasses.replace(cfg, char_vision=None), {}, engine.tok,
                               device=engine.device)
    crops = [page[int(y1):int(y2), int(x1):int(x2)] for x1, y1, x2, y2 in boxes]
    groups, host_idx = shared._prep_char_raw_groups(crops)
    if host_idx or shared.char_canvas != 448:
        fail(f"[w8a8] {len(host_idx)} crops off the device route, canvas {shared.char_canvas}")
    canvases = torch.cat([bicubic_canvas(engine._to_dev(raw), engine._to_dev(src),
                                         engine._to_dev(tgt), 448) for _, raw, src, tgt in groups])
    canvases = canvases[..., None].expand(*canvases.shape, 3)
    products = []
    product = internvit.int8_product

    def kept_product(hq, q):
        out = product(hq, q)
        if len(products) < 4:
            products.append((hq, q, out))
        return out

    rel = {}
    h.zero_counts()
    with torch.inference_mode(), ShapeLog(h.kernels) as shapes:
        for label, x in (("tile tower", tiles), ("shared char tower at 448", canvases)):
            products.clear()
            with Swap(internvit, int8_product=kept_product):
                f8 = engine._encode_tower(vit8, proj, cfg.vision, x).float()
            f16 = engine._encode_tower(vit, proj, cfg.vision, x).float()
            rel[label] = ((f8 - f16).norm() / f16.norm()).item()
            for i, (hq, q, out) in enumerate(products):
                rows = hq.reshape(-1, hq.shape[-1])[:W8A8_EXACT_ROWS]
                exact = rows.double() @ q.double()
                if not torch.equal(out.reshape(-1, out.shape[-1])[:W8A8_EXACT_ROWS].double(), exact):
                    fail(f"[w8a8] {label}: the int32 sums of layer 0's product {i} differ from "
                         f"the exact product")
            log(f"[w8a8] {label}: {tuple(x.shape)}, features rel L2 error {rel[label]:.3e} against "
                f"the bf16 tower (tol {W8A8_REL_TOL}); layer 0's four products "
                f"{[tuple(q.shape) for _, q, _ in products]} exact over {W8A8_EXACT_ROWS} rows")
            del f8, f16
    launches = h.read_counts()
    if any(r > W8A8_REL_TOL for r in rel.values()):
        fail(f"[w8a8] the W8A8 towers stray from the bf16 towers: {rel}")
    h.vit_rows("w8a8", shapes, launches)
    del vit8, tiles, canvases
    torch.cuda.empty_cache()


def parallel_phase(h, engine, batch_path):
    """Phase 29, the parallel layer. (a) The ``--mesh`` route in a world of 1
    under NCCL (``tensor=1``; its all_reduce runs, and is captured, in every
    decode graph): one page through ``batch_prepare`` on the 8b int8 engine's
    weights in the mesh's unfused layout, against the same weights without a
    mesh (token ids equal exactly, the decode graphs replayed, all_reduces
    counted inside their captures), every kernel of the batch path launched
    as often as without the mesh. (b) Each kernel at the shapes a rank of
    tensor = 2, 4, 8 gives it at the 8b's widths (random bf16 / int8
    inputs): rank 0's block timed against its plain version, rank t-1's held
    to its plain version, the head blocks concatenated against the whole
    kernel's output, the row-parallel partial sums added against the whole
    product. These shapes are off the single-card path: their rows carry 0
    launches."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from callireader_tpu_torch.core.partition import Mesh
    from callireader_tpu_torch.kernels import attention as k_attn
    from callireader_tpu_torch.kernels import decode_attention as k_dec
    from callireader_tpu_torch.kernels import int8_matmul as k_i8
    from callireader_tpu_torch.kernels import paged_decode as k_paged
    from callireader_tpu_torch.kernels import tolerance
    from callireader_tpu_torch.parallel import spmd
    from callireader_tpu_torch.parallel.tp_attention import (
        flash_attention_tp, flash_decode_tp, paged_flash_decode_tp)
    from callireader_tpu_torch.runtime import decode_graph
    from callireader_tpu_torch.runtime.engine import CalliReaderEngine
    from callireader_tpu_torch.runtime.quantize import unfuse_llm_int8

    t0 = time.time()
    dev, rnd, row_for = h.dev, h.rnd, h.row_for
    # ---- (a) the --mesh route, a world of 1 under NCCL
    rank, world = spmd.init_distributed("cuda")
    mesh = spmd.make_mesh(spmd.parse_mesh("tensor=1", world), device="cuda")
    if (rank, world, dist.get_backend()) != (0, 1, "nccl"):
        fail(f"[parallel] expected a world of 1 under NCCL, got rank {rank} of {world}, "
             f"{dist.get_backend()}")
    cfg = engine.cfg
    params = {**engine.params, "llm": unfuse_llm_int8(engine.params["llm"], cfg.llm)}
    page, boxes = make_page(0)
    runs = {}
    for label, m in (("unmeshed", None), ("mesh", mesh)):
        eng = CalliReaderEngine(cfg, params, engine.tok, device=dev, device_tile_pages=True, mesh=m)
        replays, reduces = [0], [0]  # graph replays; all_reduces made inside a capture
        call, reduce = decode_graph.StepGraph.__call__, dist.all_reduce

        def counted(graph, fn, _call=call):
            replays[0] += graph.captured and not graph.eager
            return _call(graph, fn)

        def counted_reduce(*args, _reduce=reduce, **kwargs):
            reduces[0] += torch.cuda.is_current_stream_capturing()
            return _reduce(*args, **kwargs)

        h.zero_counts()
        with Swap(decode_graph.StepGraph, __call__=counted), Swap(dist, all_reduce=counted_reduce):
            prep = eng.batch_prepare([page], [QUESTION], max_new_tokens=MESH_NEW_TOKENS,
                                     repetition_penalty=1.5, ordered_lists=[boxes],
                                     eos_token_ids=(-1,), overlap=False)
            torch.cuda.synchronize()
        runs[label] = (prep["tokens"].clone(), prep["lengths"].clone(), h.read_counts(),
                       replays[0], reduces[0])
        del eng, prep
    (tok_u, len_u, launch_u, _, _), (tok_m, len_m, launch_m, replays_m, reduces_m) = (
        runs["unmeshed"], runs["mesh"])
    missing = [n for n in batch_path if launch_m[n] == 0]
    if missing:
        fail(f"[parallel] kernels never launched on the --mesh route: {missing}")
    if launch_m != launch_u:
        fail(f"[parallel] the --mesh route launched {launch_m}, the same weights without a mesh "
             f"{launch_u}")
    if not (torch.equal(tok_m, tok_u) and torch.equal(len_m, len_u)):
        fail(f"[parallel] the --mesh route's token ids differ from the same weights' without a mesh")
    if replays_m < 1:
        fail("[parallel] the --mesh route's decode graphs never replayed")
    if reduces_m < 1:
        fail("[parallel] no all_reduce was captured in the --mesh route's decode graphs")
    log(f"[parallel] --mesh tensor=1 ({mesh.shape}, world of 1, NCCL): 1 page x {MESH_NEW_TOKENS} "
        f"token ids equal the unmeshed run's exactly, {replays_m} decode-graph replays, "
        f"{reduces_m} tensor all_reduces captured in them; launches equal the unmeshed run's "
        f"{launch_u}")
    del params
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    t_a = time.time() - t0

    # ---- (b) the shard shapes at the 8b's widths
    Hq, Hkv, D, E, M = 32, 8, 128, 4096, 14336
    ATOL = tolerance.ATOL

    def vm(t, r):
        return Mesh.virtual({"tensor": t}, {"tensor": r}, "cuda")

    def within(name, got, want, what):
        excess = tolerance.excess_error(got, want)
        if excess > ATOL[name]:
            fail(f"[parallel] {name} {what}: {excess:.3e} beyond bf16 rounding (tol {ATOL[name]})")
        return excess

    joined = {}

    def joins(name, blocks, whole_k, whole_plain, what):
        """The rank blocks joined: within the kernel's tolerance of the whole
        plain version, and of the whole kernel's output allowing each of the
        two outputs its bf16 rounding (a block's summation order, e.g. the
        decode's runs of chunks, depends on its head count)."""
        got = torch.cat(blocks, dim=1)
        within(name, got, whole_plain, what + " against the whole plain version")
        diff = (got.float() - whole_k.float()).abs()
        allow = ATOL[name] + 2 * tolerance.BF16_ROUNDING * whole_k.float().abs()
        if not bool((diff <= allow).all()):
            fail(f"[parallel] {name} {what} against the whole kernel: beyond two bf16 roundings")
        joined[f"{name} {what}"] = "bit-equal" if torch.equal(got, whole_k) \
            else f"max diff {diff.max().item():.3e}"

    def heads(x, t, r, dim=1):
        n = x.shape[dim] // t
        return x.narrow(dim, r * n, n).contiguous()

    shard_ms = {}

    def shard_row(name, t, desc, run_k, run_plain, lib, nbytes, flops, check_last):
        r = row_for(name, f"[tp t={t} rank 0] {desc}", run_k, run_plain, lib, nbytes=nbytes,
                    flops=flops)
        h.results.setdefault(name, []).append(
            (f"tp t={t} rank 0 {desc}, off the single-card path (a shard of tensor={t})", 0, r))
        shard_ms[f"{name} t={t}: {desc}"] = (round(r[1], 4),
                                            None if r[6] is None else round(r[6], 4))
        check_last()

    # prefill attention, B=1 S=3584
    S = 3584
    q, k, v = rnd((1, Hq, S, D)), rnd((1, Hkv, S, D)), rnd((1, Hkv, S, D))
    seg = torch.zeros((1, S), dtype=torch.int32, device=dev)
    seg[:, :256] = -1
    whole = k_attn.flash_attention(q, k, v, causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    whole_plain = torch.cat([k_attn.attention_reference(
        q[:, i:i + 8].float(), k[:, i // 4:i // 4 + 2].float(), v[:, i // 4:i // 4 + 2].float(),
        causal=True, q_segment_ids=seg, kv_segment_ids=seg) for i in range(0, Hq, 8)], dim=1)
    allowed = (seg[:, :, None] == seg[:, None, :]) & torch.ones((S, S), dtype=torch.bool,
                                                                  device=dev).tril()
    pairs = int(allowed.sum().item())
    for t in (2, 4, 8):
        def att(r, t=t):
            return flash_attention_tp(heads(q, t, r), heads(k, t, r), heads(v, t, r), vm(t, r),
                                      causal=True, q_segment_ids=seg, kv_segment_ids=seg)

        def att_plain(r, t=t):
            return k_attn.attention_reference(heads(q, t, r).float(), heads(k, t, r).float(),
                                              heads(v, t, r).float(), causal=True,
                                              q_segment_ids=seg, kv_segment_ids=seg)

        blocks = [att(r) for r in range(t)]
        joins("flash_attention", blocks, whole, whole_plain, f"t={t} head blocks")
        q0, k0, v0 = heads(q, t, 0), heads(k, t, 0), heads(v, t, 0)  # timed without the cut
        shard_row("flash_attention", t, f"B=1 Hq={Hq // t} Hkv={Hkv // t} S={S} D={D}",
                  lambda q0=q0, k0=k0, v0=v0, t=t: flash_attention_tp(
                      q0, k0, v0, vm(t, 0), causal=True, q_segment_ids=seg, kv_segment_ids=seg),
                  lambda: att_plain(0),
                  lambda q0=q0, k0=k0, v0=v0: F.scaled_dot_product_attention(
                      q0, k0, v0, attn_mask=allowed[:, None], enable_gqa=True),
                  2 * (2 * q0.numel() + 2 * k0.numel()) + 8 * S, 4 * pairs * (Hq // t) * D,
                  lambda t=t: within("flash_attention", att(t - 1), att_plain(t - 1),
                                     f"t={t} rank {t - 1}"))
        del blocks
    del q, k, v, whole, whole_plain, allowed
    torch.cuda.empty_cache()

    # decode attention, B=4 S=3840 (the contiguous cache of the batch path)
    B, S, L, lay = 4, 3840, 2, 1
    qd, ck, cv = rnd((B, Hq, 1, D)), rnd((L, B, Hkv, S, D)), rnd((L, B, Hkv, S, D))
    valid = torch.zeros((B, S), dtype=torch.int32, device=dev)
    for b, pad in enumerate((0, 300, 700, 1200)):
        valid[b, pad:] = 1
    n_valid = int(valid.sum().item())
    whole = k_dec.flash_decode(qd, ck, cv, lay, valid)
    whole_plain = k_dec.flash_decode_reference(qd.float(), ck, cv, lay, valid)
    for t in (2, 4, 8):
        def dec(r, t=t):
            return flash_decode_tp(heads(qd, t, r), heads(ck, t, r, 2), heads(cv, t, r, 2), lay,
                                   valid, vm(t, r))

        def dec_plain(r, t=t):
            return k_dec.flash_decode_reference(heads(qd, t, r).float(), heads(ck, t, r, 2),
                                                heads(cv, t, r, 2), lay, valid)

        joins("flash_decode", [dec(r) for r in range(t)], whole, whole_plain, f"t={t} head blocks")
        q0, c0, d0 = heads(qd, t, 0), heads(ck, t, 0, 2), heads(cv, t, 0, 2)
        shard_row("flash_decode", t, f"B={B} Hq={Hq // t} Hkv={Hkv // t} S={S} D={D} layer={lay}",
                  lambda q0=q0, c0=c0, d0=d0, t=t: flash_decode_tp(q0, c0, d0, lay, valid,
                                                                     vm(t, 0)),
                  lambda: dec_plain(0),
                  lambda q0=q0, c0=c0, d0=d0: F.scaled_dot_product_attention(
                      q0, c0[lay], d0[lay], attn_mask=(valid > 0)[:, None, None, :],
                      enable_gqa=True),
                  2 * (2 * n_valid * (Hkv // t) * D + 2 * q0.numel()) + 4 * valid.numel(),
                  4 * n_valid * (Hq // t) * D,
                  lambda t=t: within("flash_decode", dec(t - 1), dec_plain(t - 1),
                                     f"t={t} rank {t - 1}"))
    del qd, ck, cv, whole, whole_plain
    torch.cuda.empty_cache()

    # paged decode on the serve pools: 8 slots, page 128, 32 pages a slot
    Bs, page, P = SERVE_SLOTS, SERVE_PAGE, SERVE_PAGES_PER_SLOT
    NP = Bs * P + 1
    qd, kp, vp = rnd((Bs, Hq, 1, D)), rnd((L, NP, Hkv, page, D)), rnd((L, NP, Hkv, page, D))
    g = torch.Generator(device="cpu").manual_seed(29)
    table = (torch.randperm(NP - 1, generator=g)[:Bs * P] + 1).reshape(Bs, P).to(dev, torch.int32)
    lengths = torch.randint(500, P * page, (Bs,), generator=g)
    pos = torch.arange(P * page)
    pvalid = (pos[None] < lengths[:, None]).reshape(Bs, P, page).to(dev, torch.int32)
    n_valid = int(pvalid.sum().item())
    whole = k_paged.paged_flash_decode(qd, kp, vp, lay, table, pvalid)
    whole_plain = k_paged.paged_flash_decode_reference(qd.float(), kp, vp, lay, table, pvalid)
    for t in (2, 4, 8):
        def pgd(r, t=t):
            return paged_flash_decode_tp(heads(qd, t, r), heads(kp, t, r, 2), heads(vp, t, r, 2),
                                         lay, table, pvalid, vm(t, r))

        def pgd_plain(r, t=t):
            return k_paged.paged_flash_decode_reference(heads(qd, t, r).float(), heads(kp, t, r, 2),
                                                        heads(vp, t, r, 2), lay, table, pvalid)

        joins("paged_flash_decode", [pgd(r) for r in range(t)], whole, whole_plain,
              f"t={t} head blocks")
        q0, kp0, vp0 = heads(qd, t, 0), heads(kp, t, 0, 2), heads(vp, t, 0, 2)

        def yardstick(q0=q0, kp0=kp0, vp0=vp0, t=t):
            kg = kp0[lay][table.long()].permute(0, 2, 1, 3, 4).reshape(Bs, Hkv // t, P * page, D)
            vg = vp0[lay][table.long()].permute(0, 2, 1, 3, 4).reshape(Bs, Hkv // t, P * page, D)
            return F.scaled_dot_product_attention(q0, kg, vg, enable_gqa=True,
                                                  attn_mask=(pvalid > 0).reshape(Bs, 1, 1, P * page))

        shard_row("paged_flash_decode", t,
                  f"B={Bs} Hq={Hq // t} Hkv={Hkv // t} page={page} P={P} NPAGES={NP} keys={n_valid}",
                  lambda q0=q0, kp0=kp0, vp0=vp0, t=t: paged_flash_decode_tp(
                      q0, kp0, vp0, lay, table, pvalid, vm(t, 0)),
                  lambda: pgd_plain(0), yardstick,
                  2 * (2 * n_valid * (Hkv // t) * D + 2 * q0.numel())
                  + 4 * (pvalid.numel() + table.numel()),
                  4 * n_valid * (Hq // t) * D,
                  lambda t=t: within("paged_flash_decode", pgd(t - 1), pgd_plain(t - 1),
                                     f"t={t} rank {t - 1}"))
    del qd, kp, vp, whole, whole_plain
    torch.cuda.empty_cache()

    # the int8 products at the serve's 8 rows: column-parallel (wq, wk / wv,
    # w1 / w3 at N/t), row-parallel (wo, w2 at K/t), vocab-parallel LM head
    # (the vocabulary padded to 128 x 8 = 93,184 rows)
    Mr, V = SERVE_SLOTS, 93184
    gq = torch.Generator(device=dev).manual_seed(30)

    def int8_weight(K, N):
        qw = torch.randint(-127, 128, (K, N), generator=gq, device=dev, dtype=torch.int8)
        return qw, torch.rand((N,), generator=gq, device=dev) * 1e-3 + 1e-4

    for label, K, N in (("wq", E, Hq * D), ("wk", E, Hkv * D), ("w1", E, M)):
        qw, sc = int8_weight(K, N)
        x = rnd((Mr, K))
        whole = k_i8.int8_matmul(x, qw, sc)
        whole_plain = k_i8.int8_matmul_reference(x.float(), qw, sc)
        for t in (2, 4, 8):
            n = N // t

            def col(r, n=n):
                return k_i8.int8_matmul(x, qw[:, r * n:(r + 1) * n].contiguous(), sc[r * n:(r + 1) * n])

            def col_plain(r, n=n):
                return k_i8.int8_matmul_reference(x.float(), qw[:, r * n:(r + 1) * n],
                                                  sc[r * n:(r + 1) * n])

            joins("int8_matmul", [col(r) for r in range(t)], whole, whole_plain,
                  f"{label} t={t} column blocks")
            within("int8_matmul", col(t - 1), col_plain(t - 1), f"{label} t={t} rank {t - 1}")
            if label == "w1":
                w0 = (qw[:, :n].float() * sc[:n]).bfloat16()
                q0, s0 = qw[:, :n].contiguous(), sc[:n].contiguous()
                shard_row("int8_matmul", t, f"column-parallel {label} M={Mr} K={K} N={n}",
                          lambda q0=q0, s0=s0: k_i8.int8_matmul(x, q0, s0), lambda: col_plain(0),
                          lambda w0=w0: x @ w0, K * n + 4 * n + 2 * Mr * K + 2 * Mr * n,
                          2 * Mr * K * n, lambda: None)
            else:
                within("int8_matmul", col(0), col_plain(0), f"{label} t={t} rank 0")
        del qw, sc, whole, whole_plain
    for label, K, N in (("wo", Hq * D, E), ("w2", M, E)):
        qw, sc = int8_weight(K, N)
        x = rnd((Mr, K))
        plain_whole = k_i8.int8_matmul_reference(x.float(), qw, sc)
        for t in (2, 4, 8):
            kk = K // t

            def row(r, kk=kk):
                return k_i8.int8_matmul(x[:, r * kk:(r + 1) * kk].contiguous(),
                                        qw[r * kk:(r + 1) * kk].contiguous(), sc)

            def row_plain(r, kk=kk):
                return k_i8.int8_matmul_reference(x[:, r * kk:(r + 1) * kk].float(),
                                                  qw[r * kk:(r + 1) * kk], sc)

            parts = [row(r) for r in range(t)]
            plains = [row_plain(r) for r in range(t)]
            err = (sum(p.float() for p in parts) - plain_whole).abs()
            allow = sum(ATOL["int8_matmul"] + tolerance.BF16_ROUNDING * p.abs() for p in plains)
            if not bool((err <= allow).all()):
                fail(f"[parallel] {label} t={t}: the row-parallel partial sums, added, stray from "
                     f"the whole product beyond each partial's bf16 rounding + ATOL")
            within("int8_matmul", parts[-1], plains[-1], f"{label} t={t} rank {t - 1}")
            if label == "w2":
                w0 = (qw[:kk].float() * sc).bfloat16()
                x0, q0 = x[:, :kk].contiguous(), qw[:kk].contiguous()
                shard_row("int8_matmul", t, f"row-parallel {label} M={Mr} K={kk} N={N}",
                          lambda x0=x0, q0=q0: k_i8.int8_matmul(x0, q0, sc), lambda: row_plain(0),
                          lambda x0=x0, w0=w0: x0 @ w0, kk * N + 4 * N + 2 * Mr * kk + 2 * Mr * N,
                          2 * Mr * kk * N, lambda: None)
            else:
                within("int8_matmul", parts[0], plains[0], f"{label} t={t} rank 0")
            del parts, plains
        del qw, sc
    qv, _ = int8_weight(V, E)
    sv = torch.rand((V,), generator=gq, device=dev) * 1e-3 + 1e-4  # one scale a vocabulary row
    x = rnd((Mr, E))
    whole = k_i8.int8_matmul_nt(x, qv, sv)
    whole_plain = k_i8.int8_matmul_nt_reference(x.float(), qv, sv)
    for t in (2, 4, 8):
        n = V // t

        def voc(r, n=n):
            return k_i8.int8_matmul_nt(x, qv[r * n:(r + 1) * n], sv[r * n:(r + 1) * n])

        def voc_plain(r, n=n):
            return k_i8.int8_matmul_nt_reference(x.float(), qv[r * n:(r + 1) * n],
                                                 sv[r * n:(r + 1) * n])

        joins("int8_matmul_nt", [voc(r) for r in range(t)], whole, whole_plain,
              f"LM head t={t} vocab blocks")
        w0 = (qv[:n].float() * sv[:n, None]).bfloat16()
        shard_row("int8_matmul_nt", t, f"vocab-parallel LM head M={Mr} K={E} N={n}",
                  lambda n=n: k_i8.int8_matmul_nt(x, qv[:n], sv[:n]), lambda: voc_plain(0),
                  lambda w0=w0: x @ w0.T,
                  E * n + 4 * n + 2 * Mr * E + 2 * Mr * n, 2 * Mr * E * n,
                  lambda t=t: within("int8_matmul_nt", voc(t - 1), voc_plain(t - 1),
                                     f"LM head t={t} rank {t - 1}"))
        del w0
    del qv, sv, whole, whole_plain
    torch.cuda.empty_cache()
    log(f"[parallel] shard shapes at t = 2, 4, 8 on {h.smi}: ms per call (CUDA events, "
        f"profiler device ms) {json.dumps(shard_ms)}; every block held to its plain version, "
        f"the head / column / vocab blocks concatenated to the whole kernel's output, the "
        f"row-parallel partial sums to the whole product; joined against the whole kernel: "
        f"{json.dumps(joined)}")
    log(f"[parallel] phase seconds: (a) {t_a:.1f}, (b) {time.time() - t0 - t_a:.1f}")


class RowKernel:
    """The RMSNorm backward that the one-launch kernel replaced
    (tests/data/rmsnorm_bwd_rows.cu: groups of 16 rows a block with dw, each
    row read twice, dw as (blocks, E) fp32 partials that torch.sum adds),
    built with the port's nvcc flags in phase 1 beside the port's kernels
    (tools/norm_bwd_probe.py binds and launches it)."""

    @classmethod
    def start(cls, build):
        from callireader_tpu_torch.tools import norm_bwd_probe

        self = cls()
        self.probe = norm_bwd_probe
        self.so = build.BUILD_DIR / "rmsnorm_bwd_rows.so"
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.proc = subprocess.Popen(norm_bwd_probe.rows_kernel_command(self.so),
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return self

    def wait(self):
        out, _ = self.proc.communicate(timeout=900)
        if self.proc.returncode:
            fail(f"nvcc failed for {self.probe.ROWS_SOURCE}:\n{out}")
        self.fns = self.probe.bind_rows(self.so)

    def __call__(self, torch, x, w, r, dy, mode, want_dw):
        """-> (dx, dw fp32 (E,) as the old route summed it, or None)."""
        return self.probe.launch_rows(self.fns[mode], x, w, r, dy, want_dw)


def norm_rows(h):
    """Phase 19: the RMSNorm kernels against their plain versions at every
    path's shapes (E = 4096), both roundings, forward and backward (dw on
    and off), beside torch.nn.functional.rms_norm (which rounds once); the
    backward's bits equal across two runs."""
    import torch
    import torch.nn.functional as F

    from callireader_tpu_torch.kernels import rmsnorm as k_rms

    dev, eps = h.dev, 1e-5
    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).bfloat16()

    def ulp(t):
        """The spacing of bf16 values at |t|."""
        return torch.exp2(torch.floor(torch.log2(t.float().abs().clamp_min(2.0**-126))) - 7)

    def ulp_check(out_k, out_p, slack=None, what="one bf16 ulp + 1e-6"):
        """Both outputs rounded to bf16 from fp32 values a few fp32 ulps apart:
        elementwise within one bf16 ulp (plus 1e-6 for values that cancel, or
        ``slack``), and only a small share of elements apart at all."""
        got, want = out_k.float(), out_p.float()
        diff = (got - want).abs()
        tol = ulp(torch.maximum(got.abs(), want.abs())) + (1e-6 if slack is None else slack)
        ok = bool((diff <= tol).all())
        flips = int((diff > 0).sum())
        share = flips / diff.numel()
        return ok and share <= 1e-3, (f"{flips} of {diff.numel()} elements apart ({share:.2e}; "
                                      f"tol {what} each, share <= 1e-3)")

    def model_fwd_check(x, w):
        """The model's rounding: an fp32 last-bit difference in r can move
        u = bf16(x * r) by one ulp, which the weight carries into y before y's
        own rounding: |dy| <= ulp(u) |w| + ulp(y)."""
        def check(out_k, out_p):
            r = k_rms.rms_norm_fused_reference(x, w, eps, "model")[1]
            u = (x.float() * r[:, None]).bfloat16()
            return ulp_check(out_k, out_p, slack=ulp(u) * w.float().abs(),
                             what="ulp(bf16(x r)) |w| + one bf16 ulp of y")
        return check

    for path, (shapes, launches) in h.norm_shapes.items():
        fwd, bwd = {}, {}
        for call in shapes.calls["rms_norm_fwd"]:
            fwd[call] = fwd.get(call, 0) + 1
        for call in shapes.calls["rms_norm_bwd"]:
            bwd[call] = bwd.get(call, 0) + 1
        if sum(fwd.values()) != launches["rms_norm_fwd"] or sum(bwd.values()) != launches["rms_norm_bwd"]:
            fail(f"[{path}] the shape log disagrees with the RMSNorm counts")
        for (rows, E, dtype, want_r), n in sorted(fwd.items(), key=lambda kv: kv[0][0]):
            x, w = randn((rows, E), 2.0), randn((E,), 0.1, 1.0)
            nbytes = 2 * 2 * x.numel() + 2 * E + (4 * rows if want_r else 0)
            # the model rounding against its plain version on the same bf16
            # values (rounded twice as well); the fused form against the fp32
            # plain version, unrounded, as every other kernel
            for name, mode, n_launch, check, plain in (
                    ("rms_norm_fwd", "model", n, model_fwd_check(x, w),
                     lambda: k_rms.rms_norm_fused_reference(x, w, eps, "model")[0]),
                    ("rms_norm_fwd_fused", "fused", 0, None,
                     lambda: k_rms.rms_norm_fused_reference(x.float(), w.float(), eps, "fused")[0])):
                r = h.row_for(
                    name, f"[{path}] rows={rows} E={E} {mode} rounding, r out {want_r}",
                    lambda mode=mode: k_rms._launch_fwd(x, w, eps, mode, want_r)[0], plain,
                    lambda: F.rms_norm(x, (E,), w, eps), nbytes=nbytes, flops=4 * x.numel(),
                    check=check)
                h.results.setdefault(name, []).append(
                    (f"{path} rows={rows}" + ("" if n_launch else ", off the path"), n_launch, r))
            del x, w
        for (rows, E, dtype, want_dw), n in sorted(bwd.items(), key=lambda kv: kv[0][0]):
            x, w, dy = randn((rows, E), 2.0), randn((E,), 0.1, 1.0), randn((rows, E))
            _, r_model = k_rms._launch_fwd(x, w, eps, "model", True)
            _, r_fused = k_rms._launch_fwd(x, w, eps, "fused", True)
            xg, wg = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
            lib_out = F.rms_norm(xg, (E,), wg, eps)
            for name, mode, dw, n_launch, check in (
                    ("rms_norm_bwd", "model", False, n if not want_dw else 0, ulp_check),
                    ("rms_norm_bwd", "model", True, n if want_dw else 0, ulp_check),
                    ("rms_norm_bwd_fused", "fused", True, 0, None)):
                rr = r_model if mode == "model" else r_fused
                runs = [k_rms._launch_bwd(x, w, rr, dy, mode, dw) for _ in range(2)]
                if not torch.equal(runs[0][0], runs[1][0]) or (
                        dw and not torch.equal(runs[0][1], runs[1][1])):
                    fail(f"[{path}] RMSNorm backward ({mode}, dw {dw}) differs between two runs")
                what = f"[{path}] rows={rows} {mode} dw {dw}"
                # dx against the row-group kernel it replaced: within one
                # bf16 ulp, few elements apart
                ok, verdict = ulp_check(runs[0][0], h.rows_kernel(torch, x, w, rr, dy, mode, dw)[0],
                                        slack=0.0, what="one bf16 ulp")
                log(f"rms_norm_bwd {what}: dx against the row-group kernel: {verdict}")
                if not ok:
                    fail(f"{what}: RMSNorm backward dx off the row-group kernel's")
                if dw:
                    dw_k = runs[0][1]
                    dw_p = k_rms.rms_norm_bwd_reference(x, w, rr, dy, mode)[1]
                    u = (x.float() * rr[:, None]).bfloat16() if mode == "model" else x.float() * rr[:, None]
                    terms = (dy.float().abs() * u.float().abs()).sum(0)
                    if dw_k.shape != (E,):
                        fail(f"{what}: dw {tuple(dw_k.shape)}, not ({E},)")
                    dw_err = ((dw_k - dw_p).abs() / terms).max().item()
                    log(f"rms_norm_bwd {what}: dw (E,) from the launch, max err {dw_err:.3e} of "
                        f"the sum of its terms' sizes (tol 1e-5); the same bits in two runs")
                    if dw_err > 1e-5:
                        fail(f"[{path}] RMSNorm dw ({mode}) disagrees with its plain version")
                    del dw_p, u, terms
                # one launch a call of the whole route, and nothing else: the
                # wrapper's count, the profiler's device kernels (a trace late
                # in the process may hold none of this kernel's events; a
                # torch.sum's would show) and its host ops
                route = (lambda mode=mode, rr=rr, dw=dw: k_rms._bwd(x, w, rr, dy, mode, dw))
                counter = k_rms.KERNELS_BWD[mode]
                route()
                torch.cuda.synchronize()
                for _ in range(3):  # the first trace of a row has held no device events
                    before = counter.launches
                    with torch.profiler.profile(activities=[
                            torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
                        for _ in range(8):
                            route()
                        torch.cuda.synchronize()
                    made = counter.launches - before
                    on_device = [e.name for e in prof.events()
                                 if e.device_type == torch.autograd.DeviceType.CUDA]
                    ops = sorted({e.name for e in prof.events() if e.name.startswith("aten::")})
                    if on_device:
                        break
                summed = [o for o in ops if o in ("aten::sum", "aten::add", "aten::add_",
                                                  "aten::copy_", "aten::fill_", "aten::zero_")]
                log(f"rms_norm_bwd {what}: {made} launches for 8 calls of _bwd; the trace holds "
                    f"{len(on_device)} device kernels, all rmsnorm_bwd: "
                    f"{all('rmsnorm_bwd' in n for n in on_device)}; host ops {ops}")
                if made != 8 or len(on_device) > 8 or summed \
                        or any("rmsnorm_bwd" not in n for n in on_device):
                    fail(f"{what}: the backward route is not one kernel launch a call")
                # the kernel alone: CUDA events over direct launches on buffers made once
                dx_b, dw_b, part_b, blocks = k_rms._bwd_buffers(x, dw)
                args = (x.data_ptr(), w.data_ptr(), rr.data_ptr(), dy.data_ptr(), dx_b.data_ptr(),
                        None if part_b is None else part_b.data_ptr(),
                        None if dw_b is None else dw_b.data_ptr(), rows, E, blocks,
                        k_rms.DTYPES[x.dtype])
                kernel_ms = time_ms(lambda args=args, counter=counter: counter(*args), torch)
                del dx_b, dw_b, part_b
                # the function's bytes: x and dy read, dx written, w, r, dw
                nbytes = 2 * 3 * x.numel() + 2 * E + 4 * rows + (4 * E if dw else 0)
                lib_inputs = (xg, wg) if dw else (xg,)
                # (fused: the fp32 plain version on the same values, unrounded)
                ins = (x, w, dy) if mode == "model" else (x.float(), w.float(), dy.float())
                r = h.row_for(
                    name, f"[{path}] rows={rows} E={E} {mode} rounding, dw {dw}",
                    lambda route=route: route()[0],
                    lambda mode=mode, rr=rr, ins=ins: k_rms.rms_norm_bwd_reference(
                        ins[0], ins[1], rr, ins[2], mode, False)[0],
                    lambda ins=lib_inputs: torch.autograd.grad(lib_out, ins, dy, retain_graph=True),
                    nbytes=nbytes, flops=8 * x.numel(), check=check)
                was = (lambda mode=mode, rr=rr, dw=dw: h.rows_kernel(torch, x, w, rr, dy, mode, dw))
                was_ms, was_dev = time_ms(was, torch), device_ms(was, torch)[0]
                log(f"rms_norm_bwd {what}: was (the row-group kernel"
                    f"{' + torch.sum of its partials' if dw else ''}) {was_ms:.4f} ms, device "
                    f"{was_dev if was_dev is None else round(was_dev, 4)} ms; now {r[1]:.4f} ms "
                    f"(_bwd), {kernel_ms:.4f} ms (the kernel alone, {blocks} blocks), device "
                    f"{r[6] if r[6] is None else round(r[6], 4)} ms; bound {r[4]:.4f} ms")
                h.results.setdefault(name, []).append(
                    (f"{path} rows={rows} dw={'on' if dw else 'off'}"
                     + ("" if n_launch else ", off the path"), n_launch, r))
                del runs
            del x, w, dy, xg, wg, lib_out, r_model, r_fused
            torch.cuda.empty_cache()

def charprep_phase(h, crops, size, char_crops_s):
    """Phase 25: the native char-prep library (vision/native.py, built in
    phase 1) over phase 23's raw char crops, grouped into the engine's
    canvas buckets: ``char_content_batch`` against the plain route
    (preprocess.load_char_content) within CHARPREP_TOL per pixel, the same
    bytes at 1 and 8 threads, and
    ``resize_bicubic`` within RESIZE_TOL of the PIL-compatible resize
    (vision/resample.py); ms a crop on both routes, and phase 23's
    char_prep seconds against the plain route's. The geometry is held
    where it is defined: both routes white outside the content's place."""
    from callireader_tpu_torch.vision import native, preprocess, resample

    lo, hi = max(1, round(200 * size / 448)), preprocess.char_content_canvas(size)
    buckets = preprocess.char_canvas_buckets(size)
    groups = {}
    for c in crops:
        nw, nh = preprocess.char_content_dims(c.shape[1], c.shape[0], size)
        groups.setdefault(next((b for b in buckets if b >= max(nw, nh)), buckets[-1]), []).append(c)
    t0 = time.perf_counter()
    lib = {b: native.char_content_batch(cs, b, lo, hi) for b, cs in groups.items()}
    lib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = {b: np.stack([preprocess.load_char_content(c, size, canvas=b) for c in cs])
             for b, cs in groups.items()}
    plain_s = time.perf_counter() - t0
    worst = max(int(np.abs(lib[b].astype(np.int16) - plain[b].astype(np.int16)).max()) for b in groups)
    # the geometry: white wherever the content does not lie (content pixels
    # may reach 255 in one route and 254 in the other)
    pads, saturated = True, 0
    for b, cs in groups.items():
        for c, x, y in zip(cs, lib[b], plain[b]):
            nw, nh = preprocess.char_content_dims(c.shape[1], c.shape[0], size)
            pad = np.ones((b, b), bool)
            top, left = (b - nh) // 2, (b - nw) // 2
            pad[top:top + nh, left:left + nw] = False
            pads &= bool((x[pad] == 255).all() and (y[pad] == 255).all())
            saturated += int(((x == 255) != (y == 255)).any(-1).sum())
    threads = all(np.array_equal(native.char_content_batch(cs, b, lo, hi, nthreads=1), lib[b])
                  for b, cs in groups.items())
    r_worst = 0
    for c in crops[:RESIZE_CROPS]:
        nw, nh = preprocess.char_content_dims(c.shape[1], c.shape[0], size)
        got = native.resize_bicubic(c, nh, nw).astype(np.int16)
        r_worst = max(r_worst, int(np.abs(got - resample.pil_resize(c, (nw, nh), "bicubic")).max()))
    n = len(crops)
    log(f"[char prep] {n} crops of phase 23 (content size {size}, buckets "
        f"{ {b: len(cs) for b, cs in groups.items()} }): char_content_batch max |native - plain| "
        f"{worst}/255 (tol {CHARPREP_TOL}), white padding outside the content in both {pads} "
        f"({saturated} content pixels 255 in one route only), 1 and 8 threads byte-equal "
        f"{threads}; resize_bicubic on {min(n, RESIZE_CROPS)} crops max {r_worst}/255 (tol "
        f"{RESIZE_TOL}); {lib_s * 1e3 / n:.4f} ms a crop native ({lib_s:.3f} s), "
        f"{plain_s * 1e3 / n:.4f} ms plain ({plain_s:.3f} s); phase 23's char_prep span "
        f"{char_crops_s:.3f} s (the native route, grouping included); host clock, card: {h.smi}")
    if worst > CHARPREP_TOL or not pads or not threads or r_worst > RESIZE_TOL:
        fail("[char prep] the native library disagrees with the plain route")


def moonlight_phase(h):
    """Phase 31: the MLA-MoE LLM on the page route. moonlight-16b-a3b at its
    published widths (the tile tower, the compact char tower at 2048, the LLM
    cut to MOON_LAYERS layers: the dense layer 0, then expert layers), drawn
    for seed 31 with the committed detector and OrderFormer: the box stage,
    batch_build_rows, then the greedy decode of MOON_TOKENS tokens as CUDA
    graphs and uncaptured, the same token ids. Launches on the graph route:
    the latent prefill once a layer, the grouped expert kernel once an
    expert layer per prefill block of mla_moe.PREFILL_CHUNK tokens and per
    decode step, the latent decode once a layer and step; then each kernel
    against its plain version at the route's shapes (the grouped kernel at a
    decode step's rows and at a prefill block, each within the bf16
    rounding of the experts' outputs: the two sum in other orders)."""
    import torch

    from callireader_tpu_torch.core.config import get_config
    from callireader_tpu_torch.kernels import mla_decode as k_mla_dec
    from callireader_tpu_torch.kernels import mla_prefill as k_mla_pre
    from callireader_tpu_torch.kernels import moe_experts as k_moe
    from callireader_tpu_torch.models import mla_moe
    from callireader_tpu_torch.runtime import generate as gen
    from callireader_tpu_torch.runtime import weights
    from callireader_tpu_torch.runtime.engine import CalliReaderEngine
    from callireader_tpu_torch.runtime.tokenizer import InternLM2Tokenizer

    dev = h.dev
    base = get_config("moonlight-16b-a3b")
    cfg = dataclasses.replace(base, llm=dataclasses.replace(base.llm, num_hidden_layers=MOON_LAYERS))
    llm_cfg = cfg.llm
    L, Lm, k = MOON_LAYERS, cfg.llm.moe_layers, llm_cfg.num_experts_per_tok
    params = weights.init_params(cfg, 31, dtype=torch.bfloat16, device=dev)
    cfg, loaded = weights.overlay_trained_assets(params, cfg, dtype=torch.bfloat16, device=dev,
                                                 names=("detector", "orderformer"))
    engine = CalliReaderEngine(cfg, params, InternLM2Tokenizer(), device=dev, device_tile_pages=True)
    pages = [make_page(s)[0] for s in range(N_PAGES)]
    with torch.inference_mode():
        rows = engine.batch_build_rows(pages, [QUESTION] * N_PAGES,
                                       ordered_lists=engine.batch_sort_boxes(pages))
        B, S = rows["embeds"].shape[:2]
        mask = torch.from_numpy(np.ascontiguousarray(rows["mask"]))
        gen_cfg = gen.GenerateConfig(max_new_tokens=MOON_TOKENS, eos_token_ids=(-1,),
                                     pad_token_id=engine.tok.pad_token_id)
        llm = engine.params["llm"]

        def decode(eager):
            t0 = time.perf_counter()
            out = gen.generate_from_embeds(llm, llm_cfg, rows["embeds"], mask, gen_cfg=gen_cfg,
                                           max_cache_len=S + MOON_TOKENS, eager=eager)
            torch.cuda.synchronize()
            return out[0].cpu(), (time.perf_counter() - t0) * 1e3

        decode(False)  # the capture
        h.zero_counts()
        tok_graph, graph_ms = decode(False)
        launches = h.read_counts()
        steps = mla_moe.DECODE_STEPS.launches
        tok_eager, eager_ms = decode(True)  # its first readback collects the graph decode's tally
        touched = mla_moe.EXPERTS_TOUCHED.counter.launches
    blocks = -(-B * S // mla_moe.PREFILL_CHUNK)
    want = {"mla_prefill": L, "moe_experts": Lm * (blocks + steps), "latent_decode": L * steps}
    got = {n: launches[n] for n in want}
    if got != want or steps != MOON_TOKENS:
        fail(f"[mla-moe] launches {got} over {steps} decode steps, want {want} over {MOON_TOKENS}")
    if not torch.equal(tok_graph, tok_eager):
        fail("[mla-moe] the graph decode's token ids differ from the eager chunks'")
    log(f"[mla-moe] {B} pages, bucket {S}, {MOON_TOKENS} tokens: launches {got} (prefill blocks {blocks}), "
        f"{touched} (step, layer, expert) touched (of {Lm * 64 * steps}), assets {loaded}; decode "
        f"{graph_ms:.1f} ms as graphs, {eager_ms:.1f} ms eager, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # ---------------------------------------------------------- the kernels at the route's shapes
    E, Me, n = llm_cfg.hidden_size, llm_cfg.moe_intermediate_size, llm_cfg.n_routed_experts
    p = {key: v[0] for key, v in llm["moe"].items()}

    def experts_check(out_k, out_p):
        err = (out_k.float() - out_p.float()).abs().max().item()
        tol = 2 * 2 ** -8 * out_p.float().abs().max().item() + 1e-3
        return err <= tol, f"max_abs_err {err:.3e} (tol {tol:.3e}: the experts' bf16 outputs, summed in other orders)"

    for label, T in (("decode", B), ("prefill block", mla_moe.PREFILL_CHUNK)):
        x = h.rnd((T, E))
        sel, w = mla_moe.route(p, llm_cfg, x)
        r = h.row_for("moe_experts", f"{label}: T={T} E={E} Me={Me} n={n} k={k}",
                      lambda: k_moe.moe_experts(x, sel, w, p["w13"], p["w2"]),
                      lambda: k_moe.moe_experts_reference(x, sel, w, p["w13"], p["w2"]), None,
                      2 * (len(set(sel.flatten().tolist())) * 3 * E * Me + T * k * 2 * (E + Me)),
                      2 * T * k * 3 * E * Me, check=experts_check)
        h.results.setdefault("moe_experts", []).append((f"mla-moe {label}", got["moe_experts"], r))
    R, Dl = llm_cfg.kv_lora_rank, llm_cfg.latent_dim
    T = S + MOON_TOKENS
    q, kv = h.rnd((B, 16, Dl)), h.rnd((B, T, Dl))
    valid = torch.zeros((B, T), dtype=torch.int32, device=dev)
    valid[:, :S] = torch.from_numpy(np.asarray(rows["mask"])).to(dev)
    valid[:, S:] = 1
    slot = torch.tensor([T - 1], device=dev)
    keys = int(valid.sum())
    scale = llm_cfg.qk_head_dim ** -0.5
    r = h.row_for("latent_decode", f"B={B} H=16 T={T} R={R} Dr={Dl - R}, {keys} valid keys",
                  lambda: k_mla_dec.latent_decode(q, kv, valid, slot, R, scale),
                  lambda: k_mla_dec.latent_decode_reference(q.float(), kv.float(), valid, slot, R, scale),
                  None, 2 * (keys * Dl + B * 16 * (Dl + R)), 2 * keys * 16 * (Dl + R))
    h.results.setdefault("latent_decode", []).append(("mla-moe", got["latent_decode"], r))
    seg = torch.where(valid[:, :S] > 0, 0, -1).to(torch.int32)
    qp, kp, kvb = h.rnd((B, S, 16, 192)), h.rnd((B, S, 16, 192)), h.rnd((B, S, 16, 256))
    pairs = sum(int(m) * (int(m) + 1) // 2 for m in valid[:, :S].sum(1).tolist())
    r = h.row_for("mla_prefill", f"B={B} S={S} H=16 Dqk=192 Dv=128 causal, left-padded",
                  lambda: k_mla_pre.mla_prefill_attention(qp, kp, kvb[..., 128:], seg, scale=scale),
                  lambda: k_mla_pre.mla_prefill_reference(qp.float(), kp.float(), kvb[..., 128:].float(),
                                                          seg, scale), None,
                  2 * B * S * 16 * (192 * 2 + 128 * 2), 2 * pairs * 16 * (192 + 128))
    h.results.setdefault("mla_prefill", []).append(("mla-moe", got["mla_prefill"], r))
    del engine, params, llm, p
    gen.GRAPHS.clear()


def library_models_phase(h):
    """Phase 26: the library models on the card. models/moe.forward at the
    default MoEConfig widths (MOE_LAYERS layers) on B=2 S=2048 rows of two
    segments: counted (the prefill kernel once a layer, the model RMSNorm
    2L+1 times), then against the all-plain route (``use_flash=False`` and
    the plain norms): tokens whose top-2 experts differ between the routes
    are counted, every other token's logits within MODEL_REL_TOL (rel L2),
    the aux loss too. Then models/llava.llava_loss on the 2b's widths (B=2,
    256 text tokens + 1024 patches): counted (the ViT kernel once a tower
    layer, the training attention forward, dq and dk/dv and both norms' once
    a norm), its loss and the projector and LLM grads held as phase 24 holds
    a step (TrainingReferences: within twice the smaller of two noise
    witnesses; the ViT kernel runs in every route). ms, device ms and peak
    memory of both; the kernels at their shapes."""
    import torch
    import torch.nn.functional as F

    from callireader_tpu_torch.core.config import LLMConfig, get_config
    from callireader_tpu_torch.kernels import attention_bwd as k_bwd
    from callireader_tpu_torch.kernels import rmsnorm as k_rms
    from callireader_tpu_torch.models import internlm2, llava, moe
    from callireader_tpu_torch.train import e_it

    dev = h.dev
    rng = np.random.RandomState(26)

    # ---------------------------------------------------------- MoE
    cfg = moe.MoEConfig(llm=dataclasses.replace(LLMConfig(), num_hidden_layers=MOE_LAYERS))
    L, K = MOE_LAYERS, cfg.num_experts_per_tok
    params = moe.init_params(cfg, torch.Generator(device=dev).manual_seed(26), device=dev)
    expert_gb = sum(params["layers"][n].numel() for n in ("w1", "w3", "w2")) * 2 / L / 1e9
    ids = torch.from_numpy(rng.randint(3, cfg.llm.vocab_size, (MOE_B, MOE_S))).to(dev)
    seg = torch.zeros((MOE_B, MOE_S), dtype=torch.int32, device=dev)
    for b, cut in enumerate(MOE_SPLITS):
        seg[b, cut:] = 1
    routes, mlp = [], moe._moe_mlp

    def recording_mlp(p, x, c, policy, mesh=None):
        out, probs = mlp(p, x, c, policy, mesh)
        routes[-1].append(torch.topk(probs, K, dim=-1).indices.sort(dim=-1).values)
        return out, probs

    def run(use_flash):
        routes.append([])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad(), Swap(moe, _moe_mlp=recording_mlp):
            out = moe.forward(params, cfg, input_ids=ids, segment_ids=seg, use_flash=use_flash,
                              return_aux_loss=True)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    h.zero_counts()
    torch.cuda.reset_peak_memory_stats()
    with ShapeLog(h.kernels) as shapes:
        (logits_k, aux_k), first_ms = run(None)
    launches = h.read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    others = {n: c for n, c in launches.items() if n not in ("flash_attention", "rms_norm_fwd") and c}
    if launches["flash_attention"] != L or others:
        fail(f"[moe] launches {launches}: want flash_attention {L} and no other kernel but the norms")
    h.check_norms("moe", launches, L, 1)
    ms = run(None)[1]
    h.zero_counts()
    with Swap(k_rms, **h.plain_rms):
        (logits_p, aux_p), plain_ms = run(False)
    if any(h.read_counts().values()):
        fail(f"[moe] the plain route launched a kernel: {h.read_counts()}")
    flips = [(a != b).any(-1) for a, b in zip(routes[0], routes[2])]
    flipped = torch.stack(flips).any(0).reshape(MOE_B, MOE_S, 1)
    diff = torch.where(flipped, 0.0, logits_k - logits_p).square().sum().sqrt()
    ref = torch.where(flipped, 0.0, logits_p).square().sum().sqrt()
    rel = (diff / ref).item()
    aux_rel = abs(aux_k.item() - aux_p.item()) / abs(aux_p.item())
    del logits_k, logits_p, diff, ref
    log(f"[moe] forward, {L} of 32 layers at E=4096 M=14336 X=8 top-{K} Hq=32 Hkv=8 D=128 vocab "
        f"{cfg.llm.vocab_size} ({expert_gb:.3f} GB of bf16 experts a layer), B={MOE_B} S={MOE_S}, two "
        f"segments a row: {first_ms:.1f} ms counted, {ms:.1f} ms again, plain route {plain_ms:.1f} "
        f"ms (host clock, a sync at each end), peak {peak:.2f} GiB; launches "
        f"{ {n: c for n, c in launches.items() if c} }; tokens routed to other experts on the plain "
        f"route by layer {[int(f.sum()) for f in flips]}, {int(flipped.sum())} of {MOE_B * MOE_S} in "
        f"any layer; the rest's logits rel L2 {rel:.3e}, aux loss {aux_k.item():.6f} / "
        f"{aux_p.item():.6f} rel {aux_rel:.3e} (tol {MODEL_REL_TOL})")
    if rel > MODEL_REL_TOL or aux_rel > MODEL_REL_TOL:
        fail("[moe] the kernel route disagrees with the plain route")
    del params, routes
    torch.cuda.empty_cache()
    h.flash_attention_rows("moe", shapes, launches)
    h.keep_norms("moe", shapes, launches)
    del shapes
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- LLaVA
    cfg = get_config("callireader-2b")
    L = cfg.llm.num_hidden_layers
    params = llava.init_llava_params(cfg, torch.Generator(device=dev).manual_seed(27), device=dev)
    flat = e_it.flatten({"projector": params["projector"], "llm": params["llm"]})
    for leaf in flat.values():
        leaf.requires_grad_(True)
    S = LLAVA_TEXT + 1
    ids_np = rng.randint(3, cfg.llm.vocab_size, (2, S))
    for b, at in enumerate(LLAVA_IMAGE_AT):
        ids_np[b, at] = llava.IMAGE_TOKEN_INDEX
    labels_np = np.where(ids_np == llava.IMAGE_TOKEN_INDEX, -100, ids_np)
    labels_np[:, :LLAVA_PROMPT] = -100
    ids_t, labels_t = (torch.from_numpy(a).to(dev) for a in (ids_np, labels_np))
    px = torch.from_numpy(rng.randint(0, 256, (2, cfg.vision.image_size, cfg.vision.image_size, 3),
                                      dtype=np.uint8)).to(dev)

    def loss_and_grads():
        loss = llava.llava_loss(params, cfg, px, ids_t, labels_t)
        grads = torch.autograd.grad(loss, list(flat.values()))
        return loss.item(), dict(zip(flat, grads))

    h.zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with ShapeLog(h.kernels) as shapes:
        t0 = time.perf_counter()
        first = loss_and_grads()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
    launches = h.read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {"vit_attention": cfg.vision.num_hidden_layers, "attn_train_fwd": L, "attn_train_dq": L,
            "attn_train_dkv": L, "rms_norm_fwd": 2 * L + 1, "rms_norm_bwd": 2 * L + 1}
    if any(launches[n] != want.get(n, 0) for n in launches):
        fail(f"[llava] launches {launches}, want {want} and 0 elsewhere")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_and_grads()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    kern = profiled(loss_and_grads, torch)[1]
    dev_ms = sum(us for us, _ in kern.values()) / 1e3
    S2 = shapes.calls["attn_train_fwd"][0][0][2]
    log(f"[llava] llava_loss + grads of the projector and the LLM ({len(flat)} leaves), "
        f"callireader-2b widths ({cfg.vision.num_hidden_layers} ViT / {L} LLM layers), B=2, {S} ids "
        f"-> S'={S2} with {cfg.vision.num_patches} patches: loss {first[0]:.6f}; {first_ms:.1f} ms "
        f"counted, {ms:.1f} ms again (host clock, a sync at each end), {dev_ms:.1f} ms of device "
        f"kernels under the profiler; peak {peak:.2f} GiB; launches {want}")
    refs = TrainingReferences(h, torch, F, k_bwd, k_rms, internlm2)
    refs.hold("llava", "llava_loss and the projector and LLM grads", loss_and_grads,
              loss_tol=1e-3, first=first)
    del first, params, flat
    torch.cuda.empty_cache()
    h.vit_rows("llava", shapes, launches)
    q_shape, k_shape, _causal, seg = shapes.calls["attn_train_fwd"][0]
    train_attention_rows(h, f"llava B={q_shape[0]} S={q_shape[2]}", q_shape, k_shape, seg,
                         launches, k_bwd, F)
    h.keep_norms("llava", shapes, launches)
    torch.cuda.empty_cache()


def trainers_phase(h):
    """Phase 27: the asset trainers on the card. OrderFormer: 2 epochs of
    train_orderformer over OF_LAYOUTS synthetic layouts at batch 64, its loss
    below the initial one; the detector: DET_STEPS steps at 640 on one batch
    of 8 synth_calligraphy_pages, the last step's loss below the first;
    save_npz -> load_npz gives the fp16-rounded leaves bit for bit and the
    loaded tree runs in the port's Detector; then each script's main with
    tiny arguments (stdout kept: the scripts print a JSON line)."""
    import contextlib

    import torch

    from callireader_tpu_torch.core.config import DetectorConfig, OrderFormerConfig
    from callireader_tpu_torch.models import detector as det
    from callireader_tpu_torch.models import orderformer as of
    from callireader_tpu_torch.scripts import train_detector, train_orderformer
    from callireader_tpu_torch.train import detector_train as dt
    from callireader_tpu_torch.train import e_it

    dev = h.dev
    cfg = OrderFormerConfig()
    boxes, ranks, counts = train_orderformer.build_dataset(cfg, OF_LAYOUTS, 27)
    params = of.init_params(cfg, torch.Generator(device=dev).manual_seed(27), device=dev)
    before = of.evaluate_orderformer(params, cfg, boxes, ranks, counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best, loss = of.train_orderformer(params, cfg, boxes, ranks, batch_size=OF_BATCH, lr=OF_LR,
                                      epochs=OF_EPOCHS, seed=27)
    torch.cuda.synchronize()
    of_ms = (time.perf_counter() - t0) * 1e3 / (OF_LAYOUTS // OF_BATCH * OF_EPOCHS)
    after = of.evaluate_orderformer(best, cfg, boxes, ranks, counts)
    log(f"[trainers] OrderFormer ({cfg.num_layers} layers, E={cfg.model_dim}): {OF_EPOCHS} epochs of "
        f"{OF_LAYOUTS} layouts at batch {OF_BATCH}, lr {OF_LR}: mse over the layouts "
        f"{before['loss']:.4f} before, {after['loss']:.4f} after (the best epoch's mean "
        f"{loss:.4f}), order accuracy {before['order_accuracy']:.4f} -> "
        f"{after['order_accuracy']:.4f}; {of_ms:.3f} ms a step (host clock, the step's loss read "
        f"each step)")
    if not after["loss"] < before["loss"]:
        fail("[trainers] the OrderFormer's loss did not fall")

    dcfg = DetectorConfig()
    rng = np.random.RandomState(27)
    batch = dt.synth_calligraphy_pages(rng, DET_BATCH, DET_SIZE, 128,
                                       dt.make_glyph_bank(rng, DET_GLYPHS))
    imgs, gt, mask = (torch.from_numpy(a).to(dev) for a in batch)
    dparams = e_it.clone_tree(det.init_params(dcfg, torch.Generator(device=dev).manual_seed(27),
                                              device=dev), True)
    tc = dt.DetTrainConfig(total_steps=DET_STEPS, learning_rate=2e-3)
    tx = dt.make_optimizer(tc)
    opt, step = tx.init(e_it.flatten(dparams)), dt.make_train_step(dcfg, tc, tx)
    losses, times = [], []
    for _ in range(DET_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dparams, opt, m = step(dparams, opt, imgs, gt, mask)
        losses.append(m["loss"].item())
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"[trainers] detector at {DET_SIZE}, batch {DET_BATCH} ({int(mask.sum())} boxes): losses "
        f"{[round(x, 4) for x in losses]}; {np.median(times[1:]):.2f} ms a step (median of steps "
        f"2-{DET_STEPS}, the first {times[0]:.1f} ms; host clock, a sync at each end)")
    if not losses[-1] < losses[0]:
        fail("[trainers] the detector's loss did not fall")
    work = tempfile.mkdtemp(prefix="chip_smoke_trainers_")
    try:
        path = os.path.join(work, "det.npz")
        det.save_npz(path, dparams)
        loaded, saved = e_it.flatten(det.load_npz(path, dev)), e_it.flatten(dparams)
        same = sorted(loaded) == sorted(saved) and all(
            torch.equal(loaded[k], saved[k].detach().half().float()) for k in saved)
        found = det.Detector(det.load_npz(path, dev), dcfg, dev)(batch[0][0])
        if not same or not isinstance(found, list):
            fail("[trainers] save_npz -> load_npz is not the fp16-rounded tree, or the Detector "
                 "did not run on it")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            t0 = time.time()
            of_main = train_orderformer.main(["--samples", "64", "--heldout", "16", "--epochs", "1",
                                              "--batch", "32"])
            det_main = train_detector.main(["--steps", "2", "--batch", "2", "--size", "320", "--bank",
                                            "2", "--style", "boxes", "--out",
                                            os.path.join(work, "main.npz")])
            mains_s = time.time() - t0
        printed = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
        if printed != [of_main, det_main]:
            fail(f"[trainers] the scripts printed {printed}")
        log(f"[trainers] save_npz -> load_npz: the fp16-rounded leaves bit for bit, the Detector "
            f"finds {len(found)} boxes on page 0; the scripts' mains in {mains_s:.1f} s: "
            f"train_orderformer {of_main}, train_detector {det_main}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def callialign_phase(h):
    """Phase 28: the CalliAlign trainer on the card. (a) v3 at the shipping
    widths (CHAR_VISION_V3, CHAR_RESAMPLER_V3, the 92553 x 4096 float32
    table, the sub-table of every single-char piece of the tokenizer) on a
    glyph-only pool: the first step's loss and grads at batch CA_CPU_BATCH
    against the same step on the CPU, whose seed-0 table is its own draw
    (a table that depended on the device would fail it), then CA_STEPS steps of the script's
    train_loop at batch CA_BATCH (its loss falls; ms a step, peak memory),
    which ends with its eval and save_v3_asset. (b) The asset through
    apply_v3_asset into an engine whose char route (_char_pipeline_raw)
    reads CA_READOUT training crops: the ViT kernel launched once a tower
    layer at D=32 and nothing else, its pseudo tokens against v3_forward's
    in bf16 with the plain attention, the share of VQ ids that agree; the
    kernel against its plain version at that shape. (c) v2 at the 8b's tile
    tower (24-layer InternViT-300M at 448, the default resampler):
    CA_V2_STEPS steps of make_step_fn under remat at batch CA_V2_BATCH
    (finite losses, the LoRA B factors off zero, peak memory), then the
    grads with and without remat at batch 2."""
    import torch

    from callireader_tpu_torch.align import vq as vq_mod
    from callireader_tpu_torch.core.config import get_config
    from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY, FP32_POLICY, exact_fp32
    from callireader_tpu_torch.runtime.engine import CalliReaderEngine
    from callireader_tpu_torch.runtime.tokenizer import InternLM2Tokenizer
    from callireader_tpu_torch.scripts import train_callialign as script
    from callireader_tpu_torch.train import callialign_train as ca
    from callireader_tpu_torch.train import e_it

    dev = h.dev
    tok = InternLM2Tokenizer()
    work = tempfile.mkdtemp(prefix="chip_smoke_callialign_")

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()

    @contextlib.contextmanager
    def tf32():
        """TF32 products and convolutions: the witness of what the trainer's
        exact_fp32 keeps out."""
        prev = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        try:
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
                yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev[0]
            torch.set_float32_matmul_precision(prev[1])

    def loss_and_grads(loss_fn, trainable, *args, precision=exact_fp32):
        flat = e_it.flatten(trainable)
        for leaf in flat.values():
            leaf.requires_grad_(True)
        with precision():
            loss, _ = loss_fn(trainable, *args)
            grads = torch.autograd.grad(loss, list(flat.values()))
        return loss.detach(), dict(zip(flat, grads))

    def to(tree, device):
        return {k: to(v, device) if isinstance(v, dict) else v.detach().to(device).clone()
                for k, v in tree.items()}

    try:
        # ------------------------------------------------------ (a) v3
        out = os.path.join(work, "callialign.npz")
        args = script.parse_args(["--steps", str(CA_STEPS), "--batch", str(CA_BATCH),
                                  "--synth-chars", str(CA_SYNTH_CHARS), "--synth-views",
                                  str(CA_SYNTH_VIEWS), "--eval-every", str(CA_STEPS), "--out", out])
        cfg = script.v3_config()
        t0 = time.time()
        data = script.build_data(args, tok, cfg.char_vision.image_size, [], [])
        data_s = time.time() - t0
        ids = [tid for tid, _ch in data.vocab]
        crops, labels = data.pool
        frozen = ca.build_v3_frozen(cfg, class_token_ids=ids, device=dev)
        trainable = {
            "stack": ca.init_v3_params(torch.Generator(device=dev).manual_seed(28), cfg, device=dev),
            "logit_scale": torch.tensor(np.log(1 / 0.07), dtype=torch.float32, device=dev),
            "aux": ca.init_aux_head(torch.Generator(device=dev).manual_seed(29), cfg, len(ids),
                                    dim=cfg.resampler.dim, device=dev),
        }
        raw, src, tgt = ca.pack_raw_batch(crops[:CA_CPU_BATCH], input_size=cfg.char_vision.image_size)
        cls = data.cls_map[labels[:CA_CPU_BATCH]].astype(np.int32)
        batch = [torch.from_numpy(a) for a in (raw, src, tgt, cls)]
        loss_fn = ca.make_v3_loss_fn(cfg, FP32_POLICY, aux_weight=args.aux_weight)
        # the CPU side draws its own seed-0 table, as a --device cpu run does
        card_args = ({"table_sub": frozen["table_sub"]}, [b.to(dev) for b in batch])
        host_frozen = ca.build_v3_frozen(cfg, class_token_ids=ids, device="cpu")
        loss_h, grads_h = loss_and_grads(loss_fn, to(trainable, "cpu"),
                                         {"table_sub": host_frozen["table_sub"]}, batch)
        del host_frozen
        flat_h = torch.cat([g.flatten() for g in grads_h.values()])

        def against_cpu(precision):
            loss_c, grads_c = loss_and_grads(loss_fn, trainable, *card_args, precision=precision)
            worst = max((rel(grads_c[k].cpu(), grads_h[k]), k) for k in grads_h
                        if grads_h[k].norm() > 0)
            return (abs(loss_c.item() - loss_h.item()) / abs(loss_h.item()),
                    rel(torch.cat([g.flatten().cpu() for g in grads_c.values()]), flat_h), worst)

        loss_rel, grad_rel, worst = against_cpu(exact_fp32)
        tf32_loss_rel, tf32_grad_rel, _ = against_cpu(tf32)
        log(f"[callialign] v3 first step at batch {CA_CPU_BATCH}, card against CPU (float32 both, "
            f"TF32 off, each side's own seed-0 table): loss {loss_h.item():.6f}, rel {loss_rel:.3e} (tol {CA_CPU_LOSS_REL}), "
            f"grads of {len(grads_h)} leaves rel L2 {grad_rel:.3e} (tol {CA_CPU_GRAD_REL}), worst "
            f"leaf {worst[1]} {worst[0]:.3e}; the witness with TF32 on: loss rel "
            f"{tf32_loss_rel:.3e}, grads rel L2 {tf32_grad_rel:.3e}")
        if not (loss_rel <= CA_CPU_LOSS_REL and grad_rel <= CA_CPU_GRAD_REL):
            fail("[callialign] the card's v3 step disagrees with the CPU's")
        del trainable, frozen, grads_h, flat_h, card_args

        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = script.train_loop(args, cfg, data, dev)
        loop_s = time.time() - t0
        peak = (torch.cuda.max_memory_allocated() - live) / 2**30
        losses = res["losses"]
        n_par = sum(x.numel() for x in e_it.flatten(res["trainable"]["stack"]).values())
        log(f"[callialign] v3 train_loop: {n_par / 1e6:.2f}M params, {len(data.vocab)} classes in "
            f"the sub-table ({len(data.synth)} glyph classes, pool of {len(crops)} views made in "
            f"{data_s:.1f} s), {CA_STEPS} steps at batch {CA_BATCH}: loss_vq {losses[0]:.4f} -> "
            f"{losses[-1]:.4f} (mean of the last 5 {np.mean(losses[-5:]):.4f}); "
            f"{res['ms_per_step']:.2f} ms a step (host clock over steps 2-{CA_STEPS}, a sync at "
            f"each end), {loop_s:.1f} s with its eval and save; peak {peak:.2f} GiB above the "
            f"{live / 2**30:.2f} GiB live before it; eval "
            f"{res['evals']}")
        if not np.isfinite(losses).all() or not np.mean(losses[-5:]) < losses[0]:
            fail("[callialign] the v3 loss did not fall")

        # ------------------------------------------------------ (b) the readout
        base_cfg = get_config("callireader-2b")
        stack, rcfg, meta = ca.apply_v3_asset(base_cfg, out, torch.bfloat16, dev)
        V, E = rcfg.llm.vocab_size, rcfg.llm.hidden_size
        params = {**stack, "align": {
            "normed_emb": ca.align_table(V, E, torch.bfloat16, dev),
            "mu": torch.zeros((V,), dtype=torch.float32, device=dev),
            "sigma": torch.ones((V,), dtype=torch.float32, device=dev)}}
        engine = CalliReaderEngine(rcfg, params, tok, device=dev)
        raw, src, tgt = (torch.from_numpy(a).to(dev) for a in ca.pack_raw_batch(
            crops[:CA_READOUT], input_size=rcfg.char_vision.image_size))
        h.zero_counts()
        with ShapeLog(h.kernels) as shapes, torch.inference_mode():
            pseudo, idx = engine._char_pipeline_raw(raw, src, tgt)
        torch.cuda.synchronize()
        launches = h.read_counts()
        others = {n: c for n, c in launches.items() if n != "vit_attention" and c}
        dims = {a[0][-1] // 3 // a[1] for a in shapes.calls["vit_attention"]}
        if launches["vit_attention"] != rcfg.char_vision.num_hidden_layers or others or dims != {32}:
            fail(f"[callialign] the char route launched {launches} at head dims {dims}: want the ViT "
                 f"kernel {rcfg.char_vision.num_hidden_layers} times at D=32 and nothing else")
        with torch.inference_mode():
            want = ca.v3_forward(stack, rcfg, raw, src, tgt, DEFAULT_POLICY)
            want_idx, _ = vq_mod.vq_cos_sim(params["align"]["normed_emb"], want)
        got = vq_mod.normalize(pseudo.reshape(want.shape).float())
        readout_rel = rel(got, want)
        agree = (idx == want_idx).float().mean().item()
        log(f"[callialign] readout of {CA_READOUT} training crops: asset v{meta['version']} "
            f"({os.path.getsize(out) / 1e6:.1f} MB), the char route launched {launches['vit_attention']}"
            f" ViT kernels at D=32; its normalised pseudo tokens against v3_forward in bf16 with "
            f"the plain attention: rel L2 {readout_rel:.3e} (tol {MODEL_REL_TOL}), VQ ids agree "
            f"on {agree:.4f} of {idx.numel()}")
        if not readout_rel <= MODEL_REL_TOL:
            fail("[callialign] the char route's pseudo tokens disagree with v3_forward")
        h.vit_rows("callialign", shapes, launches)
        del engine, params, stack, res, pseudo, want, shapes
        torch.cuda.empty_cache()

        # ------------------------------------------------------ (c) v2 at the 8b's tile tower
        cfg8 = get_config("callireader-8b")
        canvas = cfg8.force_image_size
        frozen = ca.build_frozen(cfg8, torch.bfloat16, class_token_ids=ids, device=dev)
        base_res = ca.base_resampler_params(cfg8.resampler, torch.bfloat16, dev)
        gen = torch.Generator(device=dev).manual_seed(30)
        trainable = {
            "small": ca.small_leaves(base_res),
            "lora": ca.init_lora(gen, base_res["layers"], CA_V2_RANK),
            "vit_small": ca.vit_small_leaves(frozen["vision"]),
            "vit_lora": ca.init_vit_lora(gen, frozen["vision"]["layers"], CA_V2_RANK),
            "logit_scale": torch.tensor(np.log(1 / 0.07), dtype=torch.float32, device=dev),
            "aux": ca.init_aux_head(gen, cfg8, len(ids), device=dev),
        }
        tx = e_it.Optimizer(lambda count: CA_V2_LR, grad_clip=1.0)
        opt = tx.init(e_it.flatten(trainable))
        step = ca.make_step_fn(cfg8, canvas, DEFAULT_POLICY, tx)
        batch = [torch.from_numpy(a).to(dev) for a in (
            *ca.pack_raw_batch(crops[:CA_V2_BATCH], input_size=canvas),
            data.cls_map[labels[:CA_V2_BATCH]].astype(np.int32))]
        h.zero_counts()
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        v2_losses, times = [], []
        for _ in range(CA_V2_STEPS):
            t0 = time.perf_counter()
            trainable, opt, loss, acc, aux_acc = step(trainable, opt, frozen, base_res, batch)
            v2_losses.append(loss.item())
            times.append((time.perf_counter() - t0) * 1e3)
        peak = (torch.cuda.max_memory_allocated() - live) / 2**30
        if any(h.read_counts().values()):
            fail(f"[callialign] the v2 step launched a kernel: {h.read_counts()}")
        moved = {k: v.abs().max().item() for k, v in e_it.flatten(trainable).items()
                 if k.endswith("_b") and "lora" in k}
        log(f"[callialign] v2 at the 8b's tile tower ({cfg8.vision.num_hidden_layers}-layer "
            f"InternViT, {canvas} px, S={cfg8.vision.num_patches + 1}) and the default resampler "
            f"(dim {cfg8.resampler.dim}, depth {cfg8.resampler.depth}), LoRA rank {CA_V2_RANK}, "
            f"bf16, plain ViT attention under remat, batch {CA_V2_BATCH}: loss_vq {v2_losses}; "
            f"{times[0]:.1f} ms the first step, {np.median(times[1:]):.1f} ms after (host clock, "
            f"the loss read each step); peak {peak:.2f} GiB above the {live / 2**30:.2f} GiB live "
            f"before the steps (the tower, the table, the data); the LoRA B factors' largest |value| "
            f"{min(moved.values()):.3e} to {max(moved.values()):.3e}")
        if not np.isfinite(v2_losses).all() or not all(m > 0 for m in moved.values()):
            fail("[callialign] the v2 steps gave a non-finite loss or left a LoRA B factor at zero")
        small = [b[:2] for b in batch]
        grads = [loss_and_grads(ca.make_loss_fn(cfg8, canvas, DEFAULT_POLICY, remat=remat),
                                trainable, frozen, base_res, small)[1] for remat in (True, False)]
        remat_rel = rel(torch.cat([g.flatten().float() for g in grads[0].values()]),
                        torch.cat([g.flatten().float() for g in grads[1].values()]))
        same = sum(torch.equal(grads[0][k], grads[1][k]) for k in grads[0])
        log(f"[callialign] v2 grads at batch 2 with and without remat: rel L2 {remat_rel:.3e} (tol "
            f"{CA_REMAT_REL}), {same} of {len(grads[0])} leaves bit-equal")
        if not remat_rel <= CA_REMAT_REL:
            fail("[callialign] the v2 grads under remat disagree with those without it")
        del frozen, base_res, trainable, opt, grads
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 30


def draw_8b_int8(out_dir):
    """In a worker process: bench_8b_int8's host draws at the 8b's widths
    (numpy RandomState(0), ~1 G normal draws on one core), saved as .npy
    under ``out_dir`` -> (the leaf names, the RandomState after the draws,
    seconds)."""
    from callireader_tpu_torch.core.config import callireader_8b
    from callireader_tpu_torch.scripts import bench_8b_int8

    t0 = time.time()
    host, rng = bench_8b_int8.host_draws(callireader_8b().llm)
    for name, (q, s) in host.items():
        np.save(os.path.join(out_dir, f"{name}_q.npy"), q)
        np.save(os.path.join(out_dir, f"{name}_scale.npy"), s)
    return list(host), rng, time.time() - t0


def draw_8b_ahead():
    """bench_8b_int8's host draws for phase 30, in a worker process while
    the device-bound phases 14-28 run -> (the pool, its future, the
    directory of the draws)."""
    import concurrent.futures
    import multiprocessing

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_8b_draws_")
    pool = concurrent.futures.ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(draw_8b_int8, out_dir), out_dir


def jax_script_keys(name):
    """The keys of the JSON line of the JAX repository's scripts/<name>.py,
    read with ast (not run), with the port's changes: ``device`` and
    ``platform`` added, the TPU's roofline key renamed to the H100's."""
    import ast

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                           f"{name}.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric" for k in node.keys):
            keys |= {k.value for k in node.keys}
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript) \
                and isinstance(node.targets[0].value, ast.Name) and node.targets[0].value.id == "out":
            keys.add(node.targets[0].slice.value)
    renamed = {"roofline_ms_at_800gbps": "roofline_ms_at_3350gbps"}
    return {renamed.get(k, k) for k in keys} | {"device", "platform"}


def scripts_phase(h, ahead):
    """Phase 30: the repository's measurement scripts, ported
    (callireader_tpu_torch/scripts/), each ``main(argv)`` in process at the
    2b preset (the 8b's widths) with short counts, bench_8b_int8 at the
    8b's widths with LAYERS_8B layers on draws made ahead, mb_scan_int8 at
    MB_SCAN_L layers. Counts zeroed before each script, read after."""
    import contextlib

    from callireader_tpu_torch.core.config import get_config
    from callireader_tpu_torch.scripts import (bench_8b_int8, bench_decode, bench_http,
                                               bench_prefix, bench_serving, bench_train_step,
                                               bench_vit, mb_scan_int8)

    torch, dev, kernels = h.torch, h.dev, h.kernels
    k_i8 = kernels["int8_matmul"].module
    cfg = get_config(SCRIPTS_PRESET)
    L, L_vit = cfg.llm.num_hidden_layers, cfg.vision.num_hidden_layers
    seconds = {}

    def drive(label, mod, argv, path, keys=None, **kw):
        """``mod.main(argv)`` with every count zeroed just before and read
        just after -> (its JSON lines, launches, shape log, decode steps).
        Each line parses, carries ``keys`` (default: the JAX script's, with
        the port's changes) and finite numbers, the floats positive; every
        kernel of ``path`` launched."""
        h.zero_counts()
        buf = io.StringIO()
        t0 = time.time()
        with ShapeLog(kernels) as shapes, contextlib.redirect_stdout(buf):
            mod.main(argv, **kw)
        torch.cuda.synchronize()
        seconds[label] = round(time.time() - t0, 1)
        launches, n_dec = h.read_counts(), h.decode_steps()
        text = buf.getvalue()
        for line in text.splitlines():
            log(f"[scripts {label}] {line}")
        if not text.splitlines() or not text.splitlines()[-1].startswith("{"):
            fail(f"[scripts {label}] the script's last line is not its JSON line")
        lines = [json.loads(x) for x in text.splitlines() if x.startswith("{")]
        want = keys or jax_script_keys(mod.__name__.rsplit(".", 1)[-1])
        for line in lines:
            if set(line) != want:
                fail(f"[scripts {label}] keys {sorted(line)}, want {sorted(want)}")
            if line["device"] != h.smi or line["platform"] != "cuda":
                fail(f"[scripts {label}] device {line['device']!r} / {line['platform']!r}, want "
                     f"{h.smi!r} / 'cuda'")
            nums = {k: v for k, v in line.items()
                    if isinstance(v, (int, float)) and not isinstance(v, bool)}
            bad = {k: v for k, v in nums.items()
                   if not math.isfinite(v) or v < 0 or (isinstance(v, float) and v <= 0)}
            if bad:
                fail(f"[scripts {label}] numbers not finite and positive: {bad}")
        missing = [n for n in path if launches[n] == 0]
        if missing:
            fail(f"[scripts {label}] kernels of its path never launched: {missing} ({launches})")
        log(f"[scripts {label}] {seconds[label]} s; {n_dec} decode steps; launches "
            f"{ {n: c for n, c in launches.items() if c} }")
        return lines, launches, shapes, n_dec

    def want_launches(label, launches, want):
        got = {n: launches[n] for n in want}
        if got != want:
            fail(f"[scripts {label}] launches {got}, want {want}")

    # ---- bench_decode: the prefill twice alone, then generate twice
    T = 32
    (line,), launches, shapes, n_dec = drive(
        "decode", bench_decode, ["--preset", SCRIPTS_PRESET, "--batch", "4", "--prompt", "1024",
                                 "--tokens", str(T)],
        ("flash_attention", "flash_decode", "rms_norm_fwd"))
    want_launches("decode", launches, {"flash_decode": L * n_dec, "flash_attention": 4 * L,
                                       "vit_attention": 0, "int8_matmul": 0})
    h.check_norms("scripts decode", launches, L, 4 + n_dec)
    if not line["use_flash"]:
        fail("[scripts decode] the kernels did not run")
    h.flash_decode_row("scripts decode", shapes, launches)
    del shapes

    # ---- bench_serving: the contiguous batcher in bf16, then paged int8 at k = 8
    n_req, max_new = 8, 32
    tokens_due = sum(bench_serving.Workload(n_req, 96, 0, max_new).lengths())
    for label, extra, path, decode_kernel, n_i8 in (
            ("serving", [], ("flash_attention", "flash_decode", "rms_norm_fwd"), "flash_decode", 0),
            ("serving paged int8 k=8", ["--paged", "--quant", "int8", "--steps-per-sync", "8"],
             ("flash_attention", "paged_flash_decode", "int8_matmul", "int8_matmul_nt",
              "rms_norm_fwd"), "paged_flash_decode", 4)):
        (line,), launches, _, n_dec = drive(label, bench_serving, [
            "--preset", SCRIPTS_PRESET, "--requests", str(n_req), "--max-new", str(max_new),
            "--slots", "8", "--max-len", "1024"] + extra, path)
        if line["total_tokens"] != tokens_due:
            fail(f"[scripts {label}] {line['total_tokens']} tokens, want {tokens_due}: every "
                 f"request at its staggered length")
        want_launches(label, launches, {decode_kernel: L * n_dec, "int8_matmul": n_i8 * L * n_dec})

    # ---- bench_http: every request answers 200 (the script fails otherwise)
    (line,), launches, _, n_dec = drive(
        "http", bench_http, ["--preset", SCRIPTS_PRESET, "--requests", "8", "--max-tokens", "32",
                             "--slots", "8", "--stream"],
        ("flash_attention", "flash_decode", "rms_norm_fwd"))
    want_launches("http", launches, {"flash_decode": L * n_dec, "vit_attention": 0})

    # ---- bench_prefix: the chunked prefill's logits against the full prefill's
    iters = 2
    checks = {}
    _, launches, shapes, _ = drive(
        "prefix", bench_prefix, ["--preset", SCRIPTS_PRESET, "--rows", "4", "--prompt", "2048",
                                 "--prefix", "1536", "--iters", str(iters)],
        ("flash_attention", "rms_norm_fwd"), checks=checks)
    rel = checks["logits_rel_err"]
    log(f"[scripts prefix] the chunked prefill's last logits against the full prefill's: rel L2 "
        f"{rel:.3e} (bound {MODEL_REL_TOL})")
    if not rel <= MODEL_REL_TOL:
        fail(f"[scripts prefix] the chunked prefill's logits are {rel:.3e} rel off")
    want_launches("prefix", launches, {"flash_attention": L * (2 * (1 + iters) + 1)})
    h.flash_attention_rows("scripts prefix", shapes, launches)
    del shapes

    # ---- bench_train_step: the e-IT step on the training kernels
    steps = 1 + iters
    _, launches, _, _ = drive(
        "train step", bench_train_step, ["--preset", SCRIPTS_PRESET, "--batch", "2", "--seq",
                                         "2048", "--iters", str(iters)],
        ("vit_attention", "attn_train_fwd", "attn_train_dq", "attn_train_dkv", "rms_norm_fwd",
         "rms_norm_bwd"))
    want_launches("train step", launches, {
        "attn_train_fwd": 2 * L * steps, "attn_train_dq": L * steps, "attn_train_dkv": L * steps,
        "vit_attention": L_vit * steps, "flash_attention": 0})

    # ---- bench_vit: the kernel's encode against the plain one's
    lines, launches, _, _ = drive(
        "vit", bench_vit, ["--preset", SCRIPTS_PRESET, "--tiles", "64", "--iters", str(iters),
                           "--attn-impl", "both"], ("vit_attention",), checks=checks)
    rel = checks["encode_rel_err"]
    log(f"[scripts vit] the kernel's encode against the plain one's: rel L2 {rel:.3e} (bound "
        f"{MODEL_REL_TOL}); {[x['attn_impl'] for x in lines]}")
    if [x["attn_impl"] for x in lines] != ["auto=kernel", "reference=plain"] \
            or not rel <= MODEL_REL_TOL:
        fail(f"[scripts vit] the two routes did not both run, or disagree ({rel:.3e})")
    want_launches("vit", launches, {"vit_attention": L_vit * (1 + 2 * iters)})

    # ---- bench_8b_int8: the 8b's widths at LAYERS_8B layers, on the draws made ahead
    pool, future, out_dir = ahead
    t0 = time.time()
    names, rng, draw_s = future.result()
    pool.shutdown()
    host = {n: (np.load(os.path.join(out_dir, f"{n}_q.npy")),
                np.load(os.path.join(out_dir, f"{n}_scale.npy"))) for n in names}
    shutil.rmtree(out_dir, ignore_errors=True)
    log(f"[scripts 8b int8] host draws made ahead in {draw_s:.1f} s (waited {time.time() - t0:.1f} "
        f"s for them)")
    (line,), launches, _, n_dec = drive(
        "8b int8", bench_8b_int8, [], ("flash_attention", "flash_decode", "int8_matmul",
                                       "int8_matmul_nt", "rms_norm_fwd"),
        num_layers=LAYERS_8B, draws=(host, rng))
    del host
    if line["fits_single_chip"] is not True:
        fail("[scripts 8b int8] the run did not fit the card")
    n_gen = 1 + 3 + 1  # the warm-up, three short runs, the timed run: a prefill each
    # the prompt's 4096 rows take the int8 products' plain form, its last rows the LM head's kernel
    want_launches("8b int8", launches, {"flash_decode": LAYERS_8B * n_dec,
                                        "flash_attention": LAYERS_8B * n_gen,
                                        "int8_matmul": 4 * LAYERS_8B * n_dec,
                                        "int8_matmul_nt": n_dec + n_gen})

    # ---- mb_scan_int8: the three variants at MB_SCAN_L layers give the same bits
    env = {k: os.environ.get(k) for k in ("MB_L", "MB_WHICH")}
    os.environ["MB_L"] = str(MB_SCAN_L)
    os.environ.pop("MB_WHICH", None)
    try:
        (line,), launches, _, _ = drive(
            "mb_scan_int8", mb_scan_int8, [], ("int8_matmul",),
            keys={"metric", "L", "K", "N", "M", "bytes_per_pass", "variants", "same_bits",
                  "device", "platform"})
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if not line["same_bits"] or list(line["variants"]) != list(mb_scan_int8.VARIANTS):
        fail(f"[scripts mb_scan_int8] the variants {list(line['variants'])} disagree in bits")
    passes = 1 + 20  # the first (for the graph: its run and capture), then 20 timed
    want_launches("mb_scan_int8", launches, {"int8_matmul": 3 * MB_SCAN_L * passes})
    # the kernel at its shape, against its plain version (a cold walk over the layers)
    Lm, K, N, M = MB_SCAN_L, line["K"], line["N"], line["M"]
    g = torch.Generator(device=dev).manual_seed(0)
    wq = torch.randint(-127, 128, (Lm, K, N), generator=g, dtype=torch.int8, device=dev)
    ws = torch.rand((Lm, N), generator=g, dtype=torch.float32, device=dev) / 127.0
    x = h.rnd((M, K))
    walk, rot = [0], [0]
    wd = [(wq[Lm - 1 - i].float() * ws[Lm - 1 - i]).bfloat16()
          for i in range(max(1, -(-200_000_000 // (K * N * 2))))]

    def time_k():
        walk[0] = (walk[0] + 1) % Lm
        return k_i8.int8_matmul(x, wq[walk[0]], ws[walk[0]])

    def lib():  # the yardstick, cold: bf16 copies worth >= 200 MB
        rot[0] = (rot[0] + 1) % len(wd)
        return x @ wd[rot[0]]

    r = h.row_for("int8_matmul", f"[scripts mb_scan_int8] M={M} K={K} N={N}",
                  lambda: k_i8.int8_matmul(x, wq[Lm - 1], ws[Lm - 1]),
                  lambda: k_i8.int8_matmul_reference(x.float(), wq[Lm - 1], ws[Lm - 1]), lib,
                  nbytes=K * N + 4 * N + 2 * M * K + 2 * M * N, flops=2 * M * K * N, time_k=time_k)
    h.results.setdefault("int8_matmul", []).append(
        (f"scripts mb_scan_int8 {M}x{K}x{N}", launches["int8_matmul"], r))
    for name, v in line["variants"].items():
        log(f"[scripts mb_scan_int8] {name}: {v['ms']:.4f} ms a pass of {Lm} layers, "
            f"{v['ms'] / Lm:.4f} ms a layer, {v['gbps']:.1f} GB/s of int8 weights, "
            f"{v['share_of_3350gbps']:.1%} of 3.35 TB/s")
    del wq, ws, wd
    torch.cuda.empty_cache()
    log(f"[scripts] seconds by script: {json.dumps(seconds)}")



def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] CUDA is not available", file=sys.stderr)
        return 2
    try:
        from callireader_tpu_torch.kernels import _build
        from callireader_tpu_torch.kernels import attention as k_attn
        from callireader_tpu_torch.kernels import attention_bwd as k_bwd
        from callireader_tpu_torch.kernels import decode_attention as k_dec
        from callireader_tpu_torch.kernels import int8_matmul as k_i8
        from callireader_tpu_torch.kernels import mla_decode as k_mla_dec
        from callireader_tpu_torch.kernels import mla_prefill as k_mla_pre
        from callireader_tpu_torch.kernels import moe_experts as k_moe
        from callireader_tpu_torch.kernels import paged_decode as k_paged
        from callireader_tpu_torch.kernels import rmsnorm as k_rms
        from callireader_tpu_torch.kernels import rope_kv as k_rope
        from callireader_tpu_torch.kernels import tolerance
        from callireader_tpu_torch.kernels import vit_attention as k_vit
        from callireader_tpu_torch.models import internlm2, internvit
        from callireader_tpu_torch.runtime import decode_graph
        from callireader_tpu_torch.runtime import generate as gen_mod
        from callireader_tpu_torch.runtime import http_server, paged_cache, serving
        from callireader_tpu_torch.runtime.conversation import build_chat_prompt, get_conv_template
        from callireader_tpu_torch.runtime.engine import ALIGNED, CalliReaderEngine, build_engine
        from callireader_tpu_torch.runtime.quantize import param_bytes
        from callireader_tpu_torch.utils.profiling import SPANS
        from callireader_tpu_torch.vision import preprocess
    except ImportError as e:
        print(f"[chip_smoke] the port is not importable here: {e}", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions run in full fp32
    dev = torch.device("cuda")

    def kernel(module, counter, launch, source, replaces, tol):
        """``replaces`` None: a kernel the JAX package has none for."""
        return types.SimpleNamespace(module=module, counter=counter, launch=launch, tol=tol,
                                     source=f"callireader_tpu_torch/csrc/{source}.cu",
                                     replaces=replaces and f"callireader_tpu/kernels/{replaces}")

    kernels = {
        "vit_attention": kernel(k_vit, k_vit.KERNEL, "_launch", "vit_attention",
                                "vit_attention.py:208 (+ :73, packed_qkv_attention.py:94)",
                                "vit_attention"),
        "flash_attention": kernel(k_attn, k_attn.KERNEL, "_launch", "flash_attention",
                                  "attention.py:206", "flash_attention"),
        "flash_decode": kernel(k_dec, k_dec.KERNEL, "_launch", "flash_decode",
                               "decode_attention.py:88", "flash_decode"),
        "int8_matmul": kernel(k_i8, k_i8.KERNEL, "_launch", "int8_matmul",
                              "int8_matmul.py:131 int8_matmul_stacked (+ :187 int8_matmul)",
                              "int8_matmul"),
        "int8_matmul_nt": kernel(k_i8, k_i8.KERNEL_NT, "_launch_nt", "int8_matmul",
                                 "int8_matmul.py:74", "int8_matmul_nt"),
        "paged_flash_decode": kernel(k_paged, k_paged.KERNEL, "_launch", "paged_decode",
                                     "paged_decode.py:93 paged_flash_decode (:144)",
                                     "paged_flash_decode"),
        "attn_train_fwd": kernel(k_bwd, k_bwd.KERNEL_FWD, "_launch_fwd", "flash_attention_bwd",
                                 "attention_bwd.py:252 flash_attention_trainable, forward (:276)",
                                 "attn_train_fwd"),
        "attn_train_dq": kernel(k_bwd, k_bwd.KERNEL_DQ, "_launch_dq", "flash_attention_bwd",
                                "attention_bwd.py:315 _bwd_rule, dq (:333)", "attn_train_dq"),
        "attn_train_dkv": kernel(k_bwd, k_bwd.KERNEL_DKV, "_launch_dkv", "flash_attention_bwd",
                                 "attention_bwd.py:315 _bwd_rule, dk/dv (:360)", "attn_train_dkv"),
        # the model's two-rounding RMSNorm (every LLM norm of every path), and
        # rms_norm_pallas's own one-rounding form (held to its plain version
        # off the path, as the JAX package holds it)
        "rms_norm_fwd": kernel(k_rms, k_rms.KERNELS_FWD["model"], "_launch_fwd", "rmsnorm",
                               "rmsnorm.py:55 rms_norm_pallas, forward (:68), model rounding",
                               None),
        "rms_norm_bwd": kernel(k_rms, k_rms.KERNELS_BWD["model"], "_launch_bwd", "rmsnorm",
                               "rmsnorm.py:93 _bwd_rule (:100), model rounding", None),
        "rms_norm_fwd_fused": kernel(k_rms, k_rms.KERNELS_FWD["fused"], "_launch_fwd", "rmsnorm",
                                     "rmsnorm.py:55 rms_norm_pallas, forward (:68)", "rms_norm"),
        "rms_norm_bwd_fused": kernel(k_rms, k_rms.KERNELS_BWD["fused"], "_launch_bwd", "rmsnorm",
                                     "rmsnorm.py:93 _bwd_rule (:100)", "rms_norm"),
        # the decode token's RoPE and KV-cache write (XLA's fusion in the JAX
        # package), held to its plain form bit for bit
        "rope_kv": kernel(k_rope, k_rope.KERNEL, "_launch", "rope_kv", None, None),
        # the MLA-MoE LLM's (phase 31): the grouped expert product (its gate-up
        # launch counted; its down launch follows each), the latent decode and
        # the latent prefill attention, none with a JAX counterpart
        "moe_experts": kernel(k_moe, k_moe.KERNEL_GATE_UP, "_launch", "moe_experts", None, None),
        "latent_decode": kernel(k_mla_dec, k_mla_dec.KERNEL, "_launch", "mla_decode", None,
                                "latent_decode"),
        "mla_prefill": kernel(k_mla_pre, k_mla_pre.KERNEL, "_launch", "mla_prefill", None,
                              "mla_prefill"),
    }
    path_2b = ("vit_attention", "flash_attention", "flash_decode", "rms_norm_fwd", "rope_kv")
    batch_path = path_2b + ("int8_matmul", "int8_matmul_nt")  # batch_chat_ocr, 8b int8
    serve_path = ("vit_attention", "flash_attention", "paged_flash_decode", "int8_matmul",
                  "int8_matmul_nt", "rms_norm_fwd", "rope_kv")  # serve --paged, 8b int8
    plain_rms = dict(_fwd=lambda x, w, eps, mode, want_r: k_rms.rms_norm_fused_reference(
        x, w, eps, mode), _bwd=k_rms.rms_norm_bwd_reference)

    def check_norms(label, launches, L, n_calls):
        """The model RMSNorm forward 2L+1 times per prefill and per decode
        step (``n_calls`` of them together), the backward and the fused
        kernels never."""
        want = (2 * L + 1) * n_calls
        if launches["rms_norm_fwd"] != want or launches["rms_norm_bwd"] \
                or launches["rms_norm_fwd_fused"] or launches["rms_norm_bwd_fused"]:
            fail(f"[{label}] RMSNorm launches {launches['rms_norm_fwd']} / {launches['rms_norm_bwd']}"
                 f" / fused {launches['rms_norm_fwd_fused']} / {launches['rms_norm_bwd_fused']}, "
                 f"want {want} = (2 x {L} + 1) x {n_calls} / 0 / 0 / 0")
        log(f"[{label}] RMSNorm forward launches {want} = (2 x {L} + 1) x {n_calls} prefills and "
            f"decode steps")

    def check_rope(label, launches, L, n_dec):
        """The RoPE + KV-write kernel once a layer and decode step."""
        if launches["rope_kv"] != L * n_dec:
            fail(f"[{label}] RoPE + KV-write launches {launches['rope_kv']}, want {L} x {n_dec} "
                 f"decode steps")
        log(f"[{label}] RoPE + KV-write launches {launches['rope_kv']} = {L} x {n_dec} decode steps")

    def zero_counts():
        """Every kernel's launch count and the model's count of decode steps
        (all kept true under graph replays) to 0."""
        for c in _build.COUNTS:
            c.launches = 0

    def read_counts():
        return {name: k.counter.launches for name, k in kernels.items()}

    def decode_steps():
        """Decode steps run since zero_counts(), eager or replayed."""
        return internlm2.DECODE_STEPS.launches

    ShapeLog.install(kernels, torch, decode_graph)
    marks = []

    def phase(name):
        """Starts the wall clock of phase ``name``; None ends the last and
        prints every phase's seconds."""
        marks.append((name, time.time()))
        if name is None:
            log("seconds by phase: " + json.dumps(
                {a: round(t1 - t0, 1) for (a, t0), (_, t1) in zip(marks, marks[1:])})
                + f"; {marks[-1][1] - marks[0][1]:.1f} s in all")

    # ---------------------------------------------------------- 1. build
    phase("1 build")
    t0 = time.time()
    rows_kernel = RowKernel.start(_build)
    logs = _build.build_all(sorted({k.counter.source for k in kernels.values()}) + ["charprep"],
                            force=True)
    rows_kernel.wait()
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    log(f"built {len(logs)} libraries (the kernels with nvcc, the char-prep library with {gxx}) "
        f"in {time.time() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    gpu_name = torch.cuda.get_device_name(0)
    log(f"card: {smi}")

    gen = torch.Generator(device=dev).manual_seed(1)

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)

    def bound(nbytes, flops):
        t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def row_for(name, shape_desc, run_k, run_plain, run_lib, nbytes, flops, time_k=None,
                check=None):
        """Check ``run_k`` against ``run_plain`` (by ``check(out_k, out_p) ->
        (ok, verdict)``, default: within the output's bf16 rounding plus the
        kernel's ATOL), then time ``time_k`` (default ``run_k``), the plain
        version and the library call."""
        out_k = run_k()
        torch.cuda.synchronize()
        out_p = run_plain()
        err = tolerance.max_abs_error(out_k, out_p)
        if check is None:
            excess = tolerance.excess_error(out_k, out_p)
            tol = tolerance.ATOL[kernels[name].tol]
            ok, verdict = excess <= tol, f"beyond bf16 output rounding {excess:.3e} (tol {tol})"
        else:
            ok, verdict = check(out_k, out_p)
        del out_k, out_p
        ms = time_ms(time_k or run_k, torch)
        plain_ms = time_ms(run_plain, torch, max_iters=5)
        lib_ms = time_ms(run_lib, torch) if run_lib is not None else None
        dev_ms, dev_calls = device_ms(time_k or run_k, torch)
        dev_lib, lib_calls = device_ms(run_lib, torch) if run_lib is not None else (None, 0)
        b_ms, b_by = bound(nbytes, flops)
        log(f"{name} {shape_desc}: max_abs_err {err:.3e}, {verdict}, {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
            f"bound {b_ms:.4f} ms ({b_by}); device time from the profiler: kernel "
            f"{dev_ms if dev_ms is None else round(dev_ms, 4)} ms, library "
            f"{dev_lib if dev_lib is None else round(dev_lib, 4)} ms ({dev_calls} and {lib_calls} "
            f"of 16 calls in the trace)")
        if not ok:
            fail(f"{name} disagrees with its plain version at {shape_desc}")
        return err, ms, plain_ms, lib_ms, b_ms, b_by, dev_ms

    results = {}

    def emit():
        unlisted = [n for n in kernels if n not in results]
        if unlisted:
            fail(f"kernels without an entry in the kernels line: {unlisted}")
        line = []
        for name, entries in results.items():
            for label, n_launch, (err, ms, plain_ms, lib_ms, b_ms, b_by, dev_ms) in entries:
                row = f"{name}[{label}]"
                # device ms over the bound (CUDA-event ms where the trace lost the calls)
                ratio = (ms if dev_ms is None else dev_ms) / b_ms
                line.append({
                    "name": row,
                    "route": "cuda", "source": kernels[name].source, "replaces": kernels[name].replaces,
                    "launches": n_launch, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                    "device_ms": dev_ms, "bound_ratio": ratio,
                })
                if name.startswith("attn_train") or name in ("int8_matmul", "int8_matmul_nt",
                                                             "paged_flash_decode", "flash_decode"):
                    log(f"{row}: device {dev_ms} ms against its bound {b_ms:.4f} ms ({b_by}), "
                        f"{ratio:.2f}x")
        print(smi, flush=True)
        print(json.dumps({"kernels": line}), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": gpu_name,
                                                  "count": torch.cuda.device_count()}}), flush=True)



    pages_boxes = [make_page(seed) for seed in range(N_PAGES)]
    pages = [p for p, _ in pages_boxes]

    def run_main_path(engine, max_new_tokens, label, compact=True):
        """Warm-up of the box stage, then batch_chat_ocr with every count
        zeroed just before and read just after; the char path must run
        through the compact char tower (``compact``) or the tile tower."""
        dets = engine.batch_sort_boxes(pages)  # warm-up of the box stage, and its count
        ordered = None
        if min(len(d) for d in dets) == 0:
            ordered = [b for _, b in pages_boxes]
            log("the detector found no boxes on a synthetic page: the batch runs with the "
                "pages' known boxes through ordered_lists")
        else:
            log(f"detector + OrderFormer: {[len(d) for d in dets]} ordered char boxes per page")
        zero_counts()
        SPANS.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with ShapeLog(kernels) as shapes, CallCount(internlm2, ("prefill",), timed=("prefill",),
                                                    torch=torch) as steps, \
                CallCount(CalliReaderEngine, ("_char_encode",)) as chars:
            prepared = engine.batch_prepare(
                pages, [QUESTION] * N_PAGES, max_new_tokens=max_new_tokens,
                repetition_penalty=1.5, ordered_lists=ordered)
            t_dispatch = time.time() - t0
            texts = engine.batch_decode(prepared)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_counts()
        n_dec = decode_steps()
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[{label}] batch_chat_ocr on {N_PAGES} pages: {wall:.3f} s wall, peak memory {peak:.2f} GiB")
        log(f"[{label}] stage timings (s): "
            + json.dumps({k: round(v, 4) for k, v in SPANS.totals.items()}))
        log(f"[{label}] launches: {launches}")
        char_calls = [a for a in shapes.calls["vit_attention"]
                      if a[0][-1] // 3 // a[1] != engine.cfg.vision.head_dim]
        if not chars.n["_char_encode"] or compact != (engine.cfg.char_vision is not None) \
                or compact != bool(char_calls):
            fail(f"[{label}] the char path did not run through the "
                 f"{'compact char' if compact else 'tile'} tower")
        embeds, tokens, lengths = prepared["embeds"], prepared["tokens"], prepared["lengths"]
        if not torch.isfinite(embeds.float()).all():
            fail(f"[{label}] non-finite prompt embeddings")
        if tokens.shape != (N_PAGES, max_new_tokens) or not ((lengths >= 1) & (lengths <= max_new_tokens)).all():
            fail(f"[{label}] bad generate output shapes {tuple(tokens.shape)} {lengths.tolist()}")
        vocab = engine.cfg.llm.real_vocab_size or engine.cfg.llm.vocab_size
        if not ((tokens >= 0) & (tokens < vocab)).all():
            fail(f"[{label}] token ids out of the vocabulary ({vocab})")
        log(f"[{label}] prompt bucket {embeds.shape[1]}, generated lengths {lengths.tolist()}, "
            f"first response {texts[0][:40]!r}; batch_prepare returned after {t_dispatch:.3f} s "
            f"(the front half and the prefill's device time included: the prefill is timed "
            f"with syncs) with {n_dec} decode "
            f"steps enqueued, {prepared['pad_steps']} of them after every row was done (pad steps)")
        check_norms(label, launches, engine.cfg.llm.num_hidden_layers, steps.n["prefill"] + n_dec)
        check_rope(label, launches, engine.cfg.llm.num_hidden_layers, n_dec)
        return types.SimpleNamespace(prepared=prepared, shapes=shapes, launches=launches, wall=wall,
                                     peak=peak, steps=steps, n_dec=n_dec, ordered=ordered,
                                     spans=dict(SPANS.totals))

    # ---------------------------------------------------------- 2. main path, 2b
    phase("2-4 2b")
    t0 = time.time()
    engine = build_engine("callireader-2b", device="cuda", device_tile_pages=True)
    torch.cuda.synchronize()
    log(f"engine built in {time.time() - t0:.1f} s: char tower "
        f"{engine.cfg.char_vision.hidden_size if engine.cfg.char_vision else 'shared'} wide, "
        f"detector {'trained' if engine.cfg.detector.img_size == 640 else 'random'}")
    run2b = run_main_path(engine, MAX_NEW_TOKENS, "2b")
    missing = [n for n in path_2b if run2b.launches[n] == 0]
    if missing:
        fail(f"kernels never launched on the 2b main path: {missing}")
    shapes, launches_2b = run2b.shapes, run2b.launches
    embeds = run2b.prepared["embeds"]

    # ---------------------------------------------------------- 3. reference
    torch.manual_seed(0)
    tiles = torch.randint(0, 256, (2, 448, 448, 3), dtype=torch.uint8, device=dev)
    hid_k = internvit.forward(engine.params["vision"], engine.cfg.vision, tiles)
    with Swap(internvit, attention_from_packed_qkv_nomax=lambda qkv, h: k_vit.vit_attention_reference(qkv, h)):
        hid_p = internvit.forward(engine.params["vision"], engine.cfg.vision, tiles)
    vit_rel = ((hid_k.float() - hid_p.float()).abs().max() / hid_p.float().abs().max()).item()

    def llm_rel_err(engine, embeds, plain):
        """Prefill of one 128-token row plus one decode step through the
        kernels against the same model with the plain versions in ``plain``
        and the plain RMSNorm."""
        row = embeds[:1, -128:].contiguous()
        mask = torch.ones((1, 128), dtype=torch.int32, device=dev)
        mask[0, :17] = 0
        llm, cfg = engine.params["llm"], engine.cfg.llm
        lg_k, cache_k = internlm2.prefill(llm, cfg, inputs_embeds=row, attention_mask=mask, max_len=136)
        tok = lg_k.argmax(-1)[:, None].int()
        st_k, _ = internlm2.decode_step(llm, cfg, input_ids=tok, cache=cache_k)
        with Swap(internlm2, **plain), Swap(k_rms, **plain_rms):
            lg_p, cache_p = internlm2.prefill(llm, cfg, inputs_embeds=row, attention_mask=mask, max_len=136)
            st_p, _ = internlm2.decode_step(llm, cfg, input_ids=tok, cache=cache_p)
        vocab = cfg.real_vocab_size or cfg.vocab_size
        return max(((a[:, :vocab] - b[:, :vocab]).abs().max() / b[:, :vocab].abs().max()).item()
                   for a, b in ((lg_k, lg_p), (st_k, st_p)))

    plain_attention = dict(flash_attention=k_attn.attention_reference,
                           flash_decode=k_dec.flash_decode_reference,
                           rope_kv=k_rope.rope_kv_reference)
    llm_rel = llm_rel_err(engine, embeds, plain_attention)
    log(f"reference check: tile tower rel err {vit_rel:.3e}, LLM prefill+decode logits rel err "
        f"{llm_rel:.3e} (attention and RMSNorm plain)")
    if not (vit_rel <= 5e-2 and llm_rel <= 5e-2):
        fail("model through the kernels disagrees with the plain-attention model")

    # ---------------------------------------------------------- 4. kernels
    del engine, run2b, embeds, hid_k, hid_p
    torch.cuda.empty_cache()

    def vit_rows(path, shapes, launches):
        """The ViT kernel against its plain version: the tile tower (D=64) and
        the char tower (D=32), each at the largest batch ``path`` launched it
        with; launches split by tower."""
        towers = {}
        for (B, S, threeE), H in shapes.calls["vit_attention"]:
            key = (S, H, threeE // 3 // H)
            n, b_max = towers.get(key, (0, 0))
            towers[key] = (n + 1, max(b_max, B))
        if sum(n for n, _ in towers.values()) != launches["vit_attention"]:
            fail(f"[{path}] ViT launches by tower {towers} disagree with the kernel's count "
                 f"{launches['vit_attention']}")
        for (S, H, D), (n_calls, B) in sorted(towers.items()):
            E = H * D
            qkv = rnd((B, S, 3 * E))
            x = qkv.view(B, S, 3, H, D)
            qv, kv_, vv = (x[:, :, i].transpose(1, 2) for i in range(3))
            r = row_for("vit_attention", f"[{path}] B={B} S={S} H={H} D={D}",
                        lambda: k_vit.attention_from_packed_qkv_nomax(qkv, H),
                        lambda: k_vit.vit_attention_reference(qkv.float(), H),
                        lambda: F.scaled_dot_product_attention(qv, kv_, vv),
                        nbytes=2 * B * S * 4 * E, flops=4 * B * H * S * S * D)
            results.setdefault("vit_attention", []).append(
                (f"{path} " + "x".join(map(str, (B, S, H, D))), n_calls, r))
            del qkv, x, qv, kv_, vv

    def flash_attention_rows(path, shapes, launches):
        """Prefill attention against its plain version at every shape ``path``
        launched it with, under that shape's first segment ids. The plain
        version takes the rows four at a time (its fp32 scores of eight
        3584-token rows would not fit beside the model)."""
        groups = {}
        for call in shapes.calls["flash_attention"]:
            key = (call[0], call[1], call[5])
            n, first = groups.get(key, (0, call))
            groups[key] = (n + 1, first)
        if sum(n for n, _ in groups.values()) != launches["flash_attention"]:
            fail(f"[{path}] prefill attention launches by shape disagree with the kernel's count "
                 f"{launches['flash_attention']}")
        for n_calls, (q_shape, k_shape, causal, qseg, kseg, q_off) in groups.values():
            B, Hq, Sq, D = q_shape
            Hkv, Sk = k_shape[1], k_shape[2]
            q, k, v = rnd(q_shape), rnd(k_shape), rnd(k_shape)
            seg_mask = qseg[:, :, None] == kseg[:, None, :]
            causal_mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev).tril(q_off)
            allowed = seg_mask & causal_mask if causal else seg_mask
            pairs = int(allowed.sum().item())

            def plain():
                return torch.cat([k_attn.attention_reference(
                    q[i:i + 4].float(), k[i:i + 4].float(), v[i:i + 4].float(), causal=causal,
                    q_segment_ids=qseg[i:i + 4], kv_segment_ids=kseg[i:i + 4], q_offset=q_off)
                    for i in range(0, B, 4)])

            r = row_for("flash_attention",
                        f"[{path}] B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Sk={Sk} D={D} causal={causal} "
                        f"q_offset={q_off}",
                        lambda: k_attn.flash_attention(q, k, v, causal=causal, q_segment_ids=qseg,
                                                       kv_segment_ids=kseg, q_offset=q_off),
                        plain,
                        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=allowed[:, None],
                                                               enable_gqa=True),
                        nbytes=2 * (2 * q.numel() + 2 * k.numel()) + 4 * (qseg.numel() + kseg.numel()),
                        flops=4 * pairs * Hq * D)
            results.setdefault("flash_attention", []).append(
                (f"{path} B={B} S={Sq}", n_calls, r))
            del allowed, seg_mask, causal_mask, q, k, v
            torch.cuda.empty_cache()

    def flash_decode_row(path, shapes, launches):
        """Decode attention over the whole stacked cache against its plain
        version, with the validity of ``path``'s last step, at the deepest
        layer."""
        q_shape, c_shape, _layer, valid_d = shapes.calls["flash_decode"][-1]
        L, B, Hkv, S, D = c_shape
        Hq = q_shape[1]
        qd, ckd, cvd = rnd(q_shape), rnd(c_shape), rnd(c_shape)
        valid = valid_d.clone()
        n_valid = int((valid > 0).sum().item())
        lay = L - 1
        R = k_dec.run_chunks(B, Hkv, S)
        r = row_for("flash_decode", f"[{path}] B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} L={L} layer={lay}, "
                    f"{n_valid} valid keys, runs of {R} chunks "
                    f"({B * Hkv * -(-k_dec.n_chunks(S) // R)} blocks)",
                    lambda: k_dec.flash_decode(qd, ckd, cvd, lay, valid),
                    lambda: k_dec.flash_decode_reference(qd.float(), ckd, cvd, lay, valid),
                    lambda: F.scaled_dot_product_attention(qd, ckd[lay], cvd[lay],
                                                           attn_mask=(valid > 0)[:, None, None, :],
                                                           enable_gqa=True),
                    nbytes=2 * (2 * n_valid * Hkv * D + 2 * qd.numel()) + 4 * valid.numel(),
                    flops=4 * n_valid * Hq * D)
        # the ring's stages are refilled only after their reads (the proxy fence)
        first = k_dec.flash_decode(qd, ckd, cvd, lay, valid)
        if not all(torch.equal(k_dec.flash_decode(qd, ckd, cvd, lay, valid), first) for _ in range(19)):
            fail(f"[{path}] flash_decode gave other bits in 20 launches on the same inputs")
        log(f"[{path}] flash_decode: 20 of 20 launches on the same inputs bit-equal")
        results.setdefault("flash_decode", []).append(
            (f"{path} B={B} L={L} S={S}", launches["flash_decode"], r))
        del qd, ckd, cvd, first
        torch.cuda.empty_cache()

    def paged_row(path, shapes, launches):
        """The paged kernel against its plain version with the page table and
        validity of ``path``'s last decode step, at the deepest layer, beside
        the yardstick (gather of the slots' pages + SDPA)."""
        q_shape, pool_shape, lay, table, valid = shapes.calls["paged_flash_decode"][-1]
        Bs, Hq = q_shape[:2]
        _, NP, Hkv, page, D = pool_shape
        P = table.shape[1]
        qd, kpool, vpool = rnd(q_shape), rnd(pool_shape), rnd(pool_shape)
        n_valid = int((valid > 0).sum().item())
        live_pages = int(((valid > 0).sum(-1) > 0).sum().item())

        def yardstick():
            kg = kpool[lay][table.long()].permute(0, 2, 1, 3, 4).reshape(Bs, Hkv, P * page, D)
            vg = vpool[lay][table.long()].permute(0, 2, 1, 3, 4).reshape(Bs, Hkv, P * page, D)
            return F.scaled_dot_product_attention(qd, kg, vg, enable_gqa=True,
                                                  attn_mask=(valid > 0).reshape(Bs, 1, 1, P * page))

        r = row_for("paged_flash_decode",
                    f"[{path}] B={Bs} Hq={Hq} Hkv={Hkv} D={D} page={page} P={P} NPAGES={NP} "
                    f"L={pool_shape[0]} layer={lay}, {n_valid} live keys on {live_pages} of {Bs * P} "
                    f"table entries",
                    lambda: k_paged.paged_flash_decode(qd, kpool, vpool, lay, table, valid),
                    lambda: k_paged.paged_flash_decode_reference(qd.float(), kpool, vpool, lay, table,
                                                                 valid),
                    yardstick,
                    nbytes=2 * (2 * n_valid * Hkv * D + 2 * qd.numel())
                    + 4 * (valid.numel() + table.numel()),
                    flops=4 * n_valid * Hq * D)
        results.setdefault("paged_flash_decode", []).append(
            (f"{path} B={Bs} P={P} page={page} keys={n_valid}", launches["paged_flash_decode"], r))
        del qd, kpool, vpool
        torch.cuda.empty_cache()

    def rope_kv_row(path, shapes, launches):
        """The RoPE + KV-write kernel against its plain form (the sixteen
        eager ops a layer it replaced) at ``path``'s shapes and the rows and
        positions of its last decode step: q and both caches bit for bit
        (a destination two rows share, the paged route's trash page, left
        out: either write is right)."""
        q_shape, k_shape, c_shape, x_dtype, c_dtype, rows, pos = shapes.calls["rope_kv"][-1]
        B, Hq, _, D = q_shape
        Hkv = k_shape[1]
        N, _, T, _ = c_shape
        # a captured launch's rows and positions are kept by reference, and
        # the batch route's slot has moved one past its last write since
        rows, pos = rows.clamp(0, N - 1), pos.clamp(0, T - 1)
        qkv = torch.randn((B, 1, (Hq + 2 * Hkv) * D), generator=gen, device=dev).to(x_dtype)
        q, k, v = (t.reshape(B, 1, -1, D).transpose(1, 2)
                   for t in torch.split(qkv, [Hq * D, Hkv * D, Hkv * D], dim=-1))
        cos, sin = (torch.rand((B, 1, D), generator=gen, device=dev) * 2 - 1 for _ in range(2))
        caches = {side: torch.randn((2,) + c_shape, generator=gen, device=dev).to(c_dtype)
                  for side in ("kernel", "plain")}
        caches["plain"].copy_(caches["kernel"])
        hits = torch.zeros((N, T), dtype=torch.int32, device=dev)
        hits.index_put_((rows, pos), torch.ones_like(rows, dtype=torch.int32), accumulate=True)
        once = hits <= 1

        def run(fn, side):
            return fn(q, k, v, cos, sin, caches[side][0], caches[side][1], rows, pos)

        def check(q_k, q_p):
            by_slot = [c.permute(0, 1, 3, 2, 4)[:, once] for c in caches.values()]
            ok = torch.equal(q_k, q_p) and torch.equal(*by_slot)
            return ok, (f"q and both caches bit-equal to the plain form "
                        f"({int((hits > 1).sum())} shared destinations left out)")

        xb, cb = q.element_size(), caches["plain"].element_size()
        r = row_for("rope_kv", f"[{path}] B={B} Hq={Hq} Hkv={Hkv} D={D}, caches {c_shape} "
                    f"{c_dtype}, activations {x_dtype}",
                    lambda: run(k_rope.rope_kv, "kernel"),
                    lambda: run(k_rope.rope_kv_reference, "plain"), None,
                    nbytes=B * D * ((2 * Hq + 2 * Hkv) * xb + 2 * Hkv * cb + 8) + 16 * B,
                    flops=3 * B * (Hq + Hkv) * D, check=check)
        results.setdefault("rope_kv", []).append(
            (f"{path} B={B} N={N} T={T}", launches["rope_kv"], r))
        del qkv, caches
        torch.cuda.empty_cache()

    h = types.SimpleNamespace(torch=torch, dev=dev, kernels=kernels, zero_counts=zero_counts,
                              rows_kernel=rows_kernel,
                              read_counts=read_counts, rnd=rnd, bound=bound, row_for=row_for,
                              results=results, plain_rms=plain_rms, check_norms=check_norms,
                              flash_decode_row=flash_decode_row, vit_rows=vit_rows,
                              flash_attention_rows=flash_attention_rows,
                              decode_steps=decode_steps, norm_shapes={})

    def keep_norms(path, shapes, launches):
        """The RMSNorm launches of ``path`` by shape, for phase 19."""
        h.norm_shapes[path] = (types.SimpleNamespace(
            calls={n: list(shapes.calls[n]) for n in NORM_KERNELS}), launches)

    h.keep_norms = keep_norms
    h.smi = smi
    ATTENTION_ROWS = {"vit_attention": vit_rows, "flash_attention": flash_attention_rows,
                      "flash_decode": flash_decode_row, "paged_flash_decode": paged_row,
                      "rope_kv": rope_kv_row}

    def attention_rows(path, shapes, launches):
        """Each attention kernel ``path`` launched against its plain version
        at the shapes of that path; one row per kernel and shape, carrying
        that run's launch counts."""
        for name, rows_fn in ATTENTION_ROWS.items():
            if launches[name]:
                rows_fn(path, shapes, launches)

    attention_rows("2b", shapes, launches_2b)
    del shapes
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 22. boot from a reference checkpoint
    phase("22 boot")
    h.attention_rows = attention_rows
    boot_phase(h, run_main_path, path_2b)
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 5. main path, 8b int8
    phase("5-8 8b")
    t0 = time.time()
    from callireader_tpu_torch.core.config import get_config
    from callireader_tpu_torch.runtime import engine as engine_mod

    full8 = get_config("callireader-8b")
    cut8 = dataclasses.replace(full8, llm=dataclasses.replace(full8.llm, num_hidden_layers=LAYERS_8B))
    with Swap(engine_mod, get_config=lambda name: cut8 if name == "callireader-8b"
              else get_config(name)):
        engine = build_engine("callireader-8b", device="cuda", quant="int8",
                              device_tile_pages=True)
    torch.cuda.synchronize()
    cfg = engine.cfg.llm
    llm = engine.params["llm"]
    L = cfg.num_hidden_layers
    step_bytes = param_bytes({k: v for k, v in llm["layers"].items() if k.endswith(("_q", "_scale"))}) \
        + param_bytes([llm["output_q"], llm["output_scale"]])
    log(f"[8b] engine built in {time.time() - t0:.1f} s: ViT {engine.cfg.vision.num_hidden_layers} "
        f"layers, LLM {L} of {full8.llm.num_hidden_layers} layers int8 ({param_bytes(llm) / 1e9:.3f} GB, vocab {cfg.vocab_size} "
        f"padded from {cfg.real_vocab_size}), device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    run8 = run_main_path(engine, MAX_NEW_TOKENS_8B, "8b")
    launches_8b = run8.launches
    keep_norms("8b", run8.shapes, launches_8b)
    missing = [n for n in batch_path if launches_8b[n] == 0]
    if missing:
        fail(f"kernels never launched on the 8b int8 main path: {missing}")
    n_steps = run8.n_dec
    if run8.steps.n["prefill"] != 1 or n_steps < 1:
        fail(f"[8b] expected one prefill and some decode steps, got {run8.steps.n} and {n_steps}")
    if launches_8b["int8_matmul"] != 4 * L * n_steps:
        fail(f"[8b] (K, N) int8 launches {launches_8b['int8_matmul']} != 4 x {L} x {n_steps}")
    if launches_8b["int8_matmul_nt"] != n_steps + 1:
        fail(f"[8b] LM-head int8 launches {launches_8b['int8_matmul_nt']} != {n_steps} + 1")
    prefill_s = run8.steps.seconds["prefill"]
    decode_ms = (run8.spans["decode"] + run8.spans["readback"]) / n_steps * 1e3
    floor_ms = step_bytes / PEAK_BYTES_S * 1e3
    log(f"[8b] prefill {prefill_s:.4f} s; {n_steps} decode steps at {decode_ms:.3f} ms a step "
        f"(host clock, the decode's enqueue and batch_decode's readback); the "
        f"step's int8 weights are "
        f"{step_bytes / 1e9:.4f} GB, a floor of {floor_ms:.3f} ms at 3.35 TB/s")

    # the graphs against the same chunks run uncaptured: the main path's
    # decode, then a sampled one (a tail graph, the generator's draws)
    prep8 = run8.prepared
    mask8 = torch.from_numpy(prep8["mask"]).to(dev)
    t0 = time.time()
    eager8 = gen_mod.generate_from_embeds(llm, cfg, prep8["embeds"], mask8, gen_cfg=prep8["gen_cfg"],
                                          max_cache_len=prep8["bucket"] + MAX_NEW_TOKENS_8B,
                                          eager=True)
    torch.cuda.synchronize()
    eager_s = time.time() - t0
    if not (torch.equal(eager8[0], prep8["tokens"]) and torch.equal(eager8[1], prep8["lengths"])):
        fail(f"[8b] the graphed decode's tokens differ from the eager loop's: lengths "
             f"{prep8['lengths'].tolist()} against {eager8[1].tolist()}")
    log(f"[8b] graphed batch_chat_ocr decode = eager loop: {N_PAGES} rows x {MAX_NEW_TOKENS_8B} token "
        f"ids equal (the eager loop {eager_s:.3f} s with its prefill)")
    sampled = gen_mod.GenerateConfig(max_new_tokens=SAMPLED_TOKENS, eos_token_ids=(-1,),
                                     pad_token_id=engine.tok.pad_token_id, do_sample=True,
                                     temperature=0.8, top_k=50, top_p=0.9)
    draws = [gen_mod.generate_from_embeds(
        llm, cfg, prep8["embeds"], mask8, gen_cfg=sampled, eager=eager,
        max_cache_len=prep8["bucket"] + SAMPLED_TOKENS,
        generator=torch.Generator(device=dev).manual_seed(5))[0] for eager in (True, False)]
    if not torch.equal(draws[0], draws[1]):
        fail(f"[8b] sampled decode: the graphs drew other tokens than the eager loop "
             f"({int((draws[0] != draws[1]).sum())} of {draws[0].numel()} differ)")
    log(f"[8b] sampled decode (T 0.8, top-k 50, top-p 0.9, {SAMPLED_TOKENS} tokens: chunks and a "
        f"tail graph), seeded generator: graph = eager, {draws[0].numel()} token ids equal, "
        f"{len(set(draws[0][0].tolist()))} distinct ids in row 0")
    del eager8, draws

    def chunk_profile(mode, measure=False):
        """Host clock against device time of a decode step at the main path's
        shape, its chunks replayed as graphs or run uncaptured: 10 chunks
        timed with a sync at the end, then 4 replayed (1 uncaptured: its
        trace holds the host ops of every launch, ~25 s to process for 4)
        under torch.profiler. ``measure``: the memory of the (new) graph
        entry."""
        gcfg = gen_mod.GenerateConfig(max_new_tokens=8 * 18, eos_token_ids=(-1,),
                                      repetition_penalty=1.5)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved, allocated = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
        run = gen_mod.start_generate(llm, cfg, prep8["embeds"], mask8, gen_cfg=gcfg,
                                     max_cache_len=prep8["bucket"] + 8 * 18, eager=mode == "eager")
        run.step()
        run.step()  # the graphs' first run and capture, then a replay
        torch.cuda.synchronize()
        if measure:
            torch.cuda.empty_cache()
            cache = 2 * run.st.cache.k.numel() * 2
            state = cache + sum(t.numel() * t.element_size() for t in vars(run.st).values()
                                if isinstance(t, torch.Tensor))
            pool = (torch.cuda.memory_reserved() - reserved) - (torch.cuda.memory_allocated() - allocated)
            log(f"[8b] a decode graph entry (B={prep8['embeds'].shape[0]}, {prep8['bucket'] + 8 * 18} "
                f"cache slots): its state {state / 2**20:.1f} MiB (the KV cache {cache / 2**20:.1f}); "
                f"the capture's memory pool, reserved beyond the live tensors, {pool / 2**20:.1f} MiB")
        t0 = time.perf_counter()
        for _ in range(10):
            run.step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 80 * 1e3
        n_prof = 1 if mode == "eager" else 4
        kern, idle = device_kernels(run.step, torch, n_prof)
        if not kern:
            log(f"[8b] decode chunks, {mode}: {host_ms:.3f} ms a step on the host clock; the "
                f"profiler trace holds no device events (device ms not measured)")
            return
        steps = 8 * n_prof
        busy_ms = sum(us for us, _ in kern.values()) / steps / 1e3
        log(f"[8b] decode chunks, {mode}: {host_ms:.3f} ms a step on the host clock (no profiler), "
            f"{busy_ms:.3f} ms of device kernels a step over {steps} steps "
            f"({sum(k for _, k in kern.values()) / steps:.0f} "
            f"kernels); device idle in the trace {100 * idle:.1f}% (profiler on), 1 - device / host "
            f"ms {100 * (1 - busy_ms / host_ms):.1f}% (two runs)")

    gen_mod.GRAPHS.clear()  # the first profile makes a new entry
    for i, mode in enumerate(("graph", "eager", "eager", "graph")):  # in turns: the host drifts
        chunk_profile(mode, measure=i == 0)

    # ---------------------------------------------------------- 6. reference, 8b
    plain_int8 = dict(int8_matmul=k_i8.int8_matmul_reference,
                      int8_matmul_nt=k_i8.int8_matmul_nt_reference)
    llm_rel = llm_rel_err(engine, run8.prepared["embeds"], dict(plain_attention, **plain_int8))
    part_rel = {name: llm_rel_err(engine, run8.prepared["embeds"], plain)
                for name, plain in (("attention", plain_attention), ("int8", plain_int8))}
    log(f"[8b] reference check: LLM prefill+decode logits rel err {llm_rel:.3e} "
        f"(every kernel against its plain version; only the attention kernels and the norms "
        f"swapped {part_rel['attention']:.3e}, only the int8 kernels and the norms "
        f"{part_rel['int8']:.3e})")
    if not llm_rel <= 5e-2:
        fail("the 8b int8 model through the kernels disagrees with the plain-version model")

    # where a decode step's time goes: device kernel time against the step's
    # host-clock time (16 steps), and a profiler trace of 4 steps, at the main
    # path's shape; with the RMSNorm kernel and with the plain norm (the
    # eager ops it replaced), in turns: the host's speed drifts within a run
    embeds8 = run8.prepared["embeds"]
    B8, S8 = embeds8.shape[:2]
    n_prof, n_host = 4, 16
    logits, cache = internlm2.prefill(llm, cfg, inputs_embeds=embeds8,
                                      attention_mask=torch.ones((B8, S8), dtype=torch.int32, device=dev),
                                      max_len=S8 + 2 * n_host)
    tok = logits.argmax(-1)[:, None].int()
    state = {"cache": cache}

    def one_step():
        _, state["cache"] = internlm2.decode_step(llm, cfg, input_ids=tok, cache=state["cache"])

    def decode_step_profile(label):
        with torch.inference_mode():  # as generate runs it
            state["cache"].length = S8  # rewind: the same slots every profile
            one_step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_host):
                one_step()
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / n_host * 1e3
            state["cache"].length = S8
            kern, idle = device_kernels(one_step, torch, n_prof)
        if not kern:
            log(f"[8b] decode step profile, {label}: {step_ms:.3f} ms a step on the host clock; "
                f"the profiler trace holds no device events (not measured)")
            return
        busy_ms = sum(us for us, _ in kern.values()) / n_prof / 1e3
        top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
        log(f"[8b] decode step profile, {label}: {step_ms:.3f} ms a step on the host clock (no "
            f"profiler), {busy_ms:.3f} ms of device kernels a step "
            f"({sum(k for _, k in kern.values()) / n_prof:.0f} kernels); device idle in the trace "
            f"{100 * idle:.1f}% (profiler on), 1 - device / host ms {100 * (1 - busy_ms / step_ms):.1f}%"
            f" (two runs); by kernel (us a step, launches a step): " + "; ".join(
                f"{name[:48]} {us / n_prof:.1f} ({k // n_prof})" for name, (us, k) in top))

    for norms in ("kernel", "plain", "plain", "kernel"):
        with Swap(k_rms, **(plain_rms if norms == "plain" else {})):
            decode_step_profile(f"RMSNorm {norms}")
    for rope in ("kernel", "plain", "plain", "kernel"):
        with Swap(internlm2, **({"rope_kv": k_rope.rope_kv_reference} if rope == "plain" else {})):
            decode_step_profile(f"RoPE + KV write {rope}")
    del logits, cache, state, embeds8

    # ---------------------------------------------------------- 7. attention kernels, 8b
    attention_rows("8b", run8.shapes, launches_8b)

    # ---------------------------------------------------------- 8. int8 kernels
    layers = llm["layers"]

    def int8_row(name, label, run_k, time_k, run_plain, wd, nt, M, K, N, n_launch):
        x = rnd((M, K))
        n_rot = max(1, min(len(wd), -(-200_000_000 // (K * N * 2))))
        rot = [0]

        def lib():  # the yardstick, cold: walks bf16 copies worth >= 200 MB
            rot[0] = (rot[0] + 1) % n_rot
            return x @ (wd[rot[0]].T if nt else wd[rot[0]])

        r = row_for(name, f"{label} M={M} K={K} N={N}", lambda: run_k(x), lambda: run_plain(x.float()),
                    lib, nbytes=K * N + 4 * N + 2 * M * K + 2 * M * N, flops=2 * M * K * N,
                    time_k=lambda: time_k(x))
        results.setdefault(name, []).append((f"{label} {M}x{K}x{N}", n_launch, r))

    def int8_rows(path, shapes, launches, llm=llm):
        """Each int8 kernel against its plain version at every (M, K, N)
        ``path`` launched it with (the four layer projections of ``llm``'s
        last layer, the LM head) -> {(projection, M): launches}."""
        layers = llm["layers"]
        L = layers["wqkv_q"].shape[0]
        kn_shapes = {}
        for shape in shapes.calls["int8_matmul"]:
            kn_shapes[shape] = kn_shapes.get(shape, 0) + 1
        counts_shapes = dict(kn_shapes)
        nt_shapes = {}
        for shape in shapes.calls["int8_matmul_nt"]:
            nt_shapes[shape] = nt_shapes.get(shape, 0) + 1
        if sum(kn_shapes.values()) != launches["int8_matmul"] \
                or sum(nt_shapes.values()) != launches["int8_matmul_nt"]:
            fail(f"[{path}] int8 launches seen by the shape log disagree with the kernels' counts")
        counts = {}
        for label in ("wqkv", "wo", "w13", "w2"):
            q, s = layers[f"{label}_q"], layers[f"{label}_scale"]
            K, N = q.shape[1:]
            walk = [0]

            def time_k(x, q=q, s=s):  # cold: one layer after the other, as in decode
                walk[0] = (walk[0] + 1) % L
                return k_i8.int8_matmul(x, q[walk[0]], s[walk[0]])

            n_copies = max(1, -(-200_000_000 // (K * N * 2)))
            wd = [(q[L - 1 - i].float() * s[L - 1 - i]).bfloat16() for i in range(min(n_copies, L))]
            for M in sorted(m for (m, k, n) in kn_shapes if (k, n) == (K, N)):
                counts[label, M] = kn_shapes.pop((M, K, N))
                int8_row("int8_matmul", f"{path} {label}",
                         lambda x, q=q, s=s: k_i8.int8_matmul(x, q[L - 1], s[L - 1]), time_k,
                         lambda xf, q=q, s=s: k_i8.int8_matmul_reference(xf, q[L - 1], s[L - 1]),
                         wd, False, M, K, N, counts[label, M])
            if label == "w13":  # a row's outputs do not depend on the rows launched with it
                for M in sorted(m for (m, _k, _n) in counts_shapes if (_k, _n) == (K, N)):
                    x = rnd((M, K))
                    together = k_i8.int8_matmul(x, q[L - 1], s[L - 1])
                    if not all(torch.equal(together[m:m + 1],
                                           k_i8.int8_matmul(x[m:m + 1].contiguous(), q[L - 1], s[L - 1]))
                               for m in range(M)):
                        fail(f"[{path}] a (K, N) {label} row launched with {M} rows differs from it "
                             f"launched alone")
                    log(f"[{path}] (K, N) {label}: each of {M} rows equals its launch alone bit for bit")
            del wd
            torch.cuda.empty_cache()
        if kn_shapes:
            fail(f"[{path}] (K, N) int8 launches at shapes of no layer projection: {kn_shapes}")

        q, s = llm["output_q"], llm["output_scale"].reshape(-1)
        N, K = q.shape
        wd = [(q.float() * s[:, None]).bfloat16()]
        for (M, k, n), n_launch in sorted(nt_shapes.items()):
            if (k, n) != (K, N):
                fail(f"[{path}] LM-head kernel launched at {(M, k, n)}, the head is {(K, N)}")
            counts["lm_head", M] = n_launch
            int8_row("int8_matmul_nt", f"{path} lm_head", lambda x: k_i8.int8_matmul_nt(x, q, s),
                     lambda x: k_i8.int8_matmul_nt(x, q, s),
                     lambda xf: k_i8.int8_matmul_nt_reference(xf, q, s), wd, True, M, K, N, n_launch)
            x = rnd((M, K))  # a row's logits do not depend on the rows launched with it
            together = k_i8.int8_matmul_nt(x, q, s)
            if not all(torch.equal(together[m:m + 1], k_i8.int8_matmul_nt(x[m:m + 1].contiguous(), q, s))
                       for m in range(M)):
                fail(f"[{path}] an LM-head row launched with {M} rows differs from it launched alone")
            log(f"[{path}] LM head: each of {M} rows equals its launch alone bit for bit")
        del wd
        torch.cuda.empty_cache()
        return counts

    h.int8_rows = int8_rows
    counts = int8_rows("8b", run8.shapes, launches_8b)
    M = N_PAGES
    want = {**{(label, M): L * n_steps for label in ("wqkv", "wo", "w13", "w2")},
            ("lm_head", M): n_steps + 1}
    if counts != want:
        fail(f"[8b] int8 launches by projection and rows {counts}, expected {want}")
    del run8
    torch.cuda.empty_cache()

    # fused products, split, equal the separate products bit for bit
    x = rnd((M, cfg.hidden_size))
    D = cfg.head_dim
    for label, splits in (("wqkv", [cfg.num_attention_heads * D, cfg.num_key_value_heads * D,
                                    cfg.num_key_value_heads * D]),
                          ("w13", [cfg.intermediate_size] * 2)):
        q, s = layers[f"{label}_q"][L - 1], layers[f"{label}_scale"][L - 1, 0]
        fused = k_i8.int8_matmul(x, q, s)
        for i, (got, qp, sp) in enumerate(zip(fused.split(splits, 1), q.split(splits, 1), s.split(splits))):
            if not torch.equal(got, k_i8.int8_matmul(x, qp.contiguous(), sp.contiguous())):
                fail(f"fused {label} part {i} differs from its separate product")
    log("fused wqkv / w13 outputs, split, equal the separate products bit for bit")

    # ---------------------------------------------------------- 9. serve, paged
    phase("9-13 serve")
    del x, fused
    torch.cuda.empty_cache()
    vcfg = engine.cfg
    vocab = cfg.real_vocab_size or cfg.vocab_size
    eos = (engine.tok.convert_tokens_to_ids(get_conv_template(vcfg.template).sep),)
    serve_pages = [make_page(seed)[0] for seed in range(SERVE_SLOTS)]

    def serve_rows(pages_np):
        """One wave of request rows the way cli/serve.py prepares it; logs
        the seconds of each part (a device sync ends each)."""
        spans, t0 = {}, time.perf_counter()

        def lap(name):
            nonlocal t0
            torch.cuda.synchronize()
            spans[name], t0 = round(time.perf_counter() - t0, 4), time.perf_counter()

        aligned = engine.batch_calli_align(pages_np)
        lap("batch_calli_align")
        pixel = [preprocess.load_image(pg, vcfg.force_image_size, vcfg.max_dynamic_patch,
                                       vcfg.use_thumbnail) for pg in pages_np]
        lap("host_load_image")
        feats = engine.encode_image_tiles(engine._to_dev(np.concatenate(pixel, axis=0)))
        lap("encode_image_tiles")
        rows, off = [], 0
        for (pseudo, _idx), px in zip(aligned, pixel):
            n = px.shape[0]
            question = "<image>\n" + QUESTION
            if pseudo is not None:
                question += ALIGNED * pseudo.shape[0]
            query = engine._expand_image_tokens(build_chat_prompt(question).get_prompt(), [n])
            ids = engine._tokenize_prompt(query)
            bucket = gen_mod.bucket_length(len(ids))
            embeds, _mask = engine._build_row_embeds(ids, feats[off:off + n], pseudo, bucket)
            off += n
            rows.append(embeds[0, bucket - len(ids):])
        lap("tokenize_build_rows")
        log(f"[serve] front half of {len(pages_np)} pages ({sum(p.shape[0] for p in pixel)} tiles), "
            f"seconds: {json.dumps(spans)}")
        return rows

    def paged_batcher(steps_per_sync=1, num_pages=SERVE_SLOTS * SERVE_PAGES_PER_SLOT + 1, **kw):
        return paged_cache.PagedBatcher(
            llm, cfg, num_slots=SERVE_SLOTS, num_pages=num_pages, page_size=SERVE_PAGE,
            max_pages_per_slot=SERVE_PAGES_PER_SLOT, policy=engine.policy,
            steps_per_sync=steps_per_sync, **kw)

    def requests_for(rows, max_new):
        return [serving.Request(uid, row.float().cpu().numpy(), dev_embeds=row,
                                max_new_tokens=max_new, eos_token_ids=eos)
                for uid, row in enumerate(rows)]

    def check_done(label, done, n, batcher, num_pages):
        if len(done) != n:
            fail(f"[{label}] {len(done)} of {n} requests came back")
        for r in done:
            if r.error is None and not (r.tokens and all(0 <= t < vocab for t in r.tokens)):
                fail(f"[{label}] request {r.uid}: no tokens, or ids outside the vocabulary ({vocab})")
        if len(batcher.pool.free) != num_pages - 1 or any(sl is not None for sl in batcher.slots):
            fail(f"[{label}] {num_pages - 1 - len(batcher.pool.free)} pages did not return to the pool")

    def serve_run(label, steps_per_sync, rows=None, eager=False):
        """Submit 8 rows to a fresh PagedBatcher and drain it; every count
        zeroed just before, read just after. ``rows`` None: the wave's front
        half (tiling, detector, char path, tile tower) runs inside the counted
        region too. ``eager``: the ticks uncaptured."""
        num_pages = SERVE_SLOTS * SERVE_PAGES_PER_SLOT + 1
        batcher = paged_batcher(steps_per_sync, eager=eager)
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t_prep = time.time()
        with ShapeLog(kernels) as shapes, \
                CallCount(internlm2, ("prefill",), timed=("prefill",), torch=torch) as pre:
            if rows is None:
                rows = serve_rows(serve_pages)
            torch.cuda.synchronize()
            t0 = time.time()
            for r in requests_for(rows, SERVE_NEW_TOKENS):
                batcher.submit(r)
            done = batcher.run()
            torch.cuda.synchronize()
            wall = time.time() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_done(label, done, len(rows), batcher, num_pages)
        if any(r.error is not None for r in done):
            fail(f"[{label}] a request failed: {[r.error for r in done if r.error]}")
        n_dec, n_pre = decode_steps(), pre.n["prefill"]
        n_tok = sum(len(r.tokens) for r in done)
        log(f"[{label}] front half {t0 - t_prep:.3f} s; {len(rows)} rows of "
            f"{[int(r.shape[0]) for r in rows]} tokens, {batcher._admit_seq} admissions in {n_pre} "
            f"prefill(s) of {pre.seconds['prefill']:.4f} s; {n_dec} decode steps at "
            f"{(wall - pre.seconds['prefill']) / n_dec * 1e3:.3f} ms a step (host clock, run minus "
            f"prefill); {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tokens/s; "
            f"{batcher.n_preempted} preemptions; peak memory {peak:.2f} GiB; launches {launches}")
        if n_dec < 1 or launches["paged_flash_decode"] != L * n_dec:
            fail(f"[{label}] paged kernel launches {launches['paged_flash_decode']} != {L} x {n_dec}")
        if launches["flash_decode"] != 0:
            fail(f"[{label}] flash_decode launched {launches['flash_decode']} times on the paged path")
        if launches["int8_matmul"] != 4 * L * n_dec or launches["int8_matmul_nt"] != n_dec + n_pre:
            fail(f"[{label}] int8 launches {launches['int8_matmul']} / {launches['int8_matmul_nt']} "
                 f"!= 4 x {L} x {n_dec} / {n_dec} + {n_pre}")
        if launches["flash_attention"] != L * n_pre:
            fail(f"[{label}] prefill attention launches {launches['flash_attention']} != {L} x {n_pre}")
        check_norms(label, launches, L, n_pre + n_dec)
        check_rope(label, launches, L, n_dec)
        if not eager and not batcher._tick.captured:
            fail(f"[{label}] the ticks were not captured")
        return types.SimpleNamespace(rows=rows, launches=launches, shapes=shapes, n_dec=n_dec,
                                     tokens={r.uid: r.tokens for r in done})

    serve1 = serve_run("serve k=1", 1)
    keep_norms("serve", serve1.shapes, serve1.launches)
    missing = [n for n in serve_path if serve1.launches[n] == 0]
    if missing:
        fail(f"kernels never launched on the paged serve path: {missing}")
    rows = serve1.rows
    serve8 = serve_run("serve k=8", 8, rows=rows)
    # the graphed ticks against the same ticks run uncaptured (serve k=1 ran
    # the wave's front half too: the ViT launches are not the ticks')
    for k, graphed in ((1, serve1), (8, serve8)):
        eager = serve_run(f"serve k={k} eager", k, rows=rows, eager=True)
        if eager.tokens != graphed.tokens or eager.n_dec != graphed.n_dec or any(
                eager.launches[n] != graphed.launches[n] for n in serve_path if n != "vit_attention"):
            fail(f"[serve k={k}] the graphed ticks gave other tokens or launches than the eager "
                 f"ones: {graphed.launches} / {eager.launches}")
        log(f"[serve k={k}] graphed ticks = eager ticks: {len(eager.tokens)} requests, "
            f"{sum(len(t) for t in eager.tokens.values())} token ids equal, {eager.n_dec} decode "
            f"steps and the launches of every kernel of the ticks and the prefill equal")
    del serve8, eager

    def step_profile(k, eager=False):
        """Host clock against device kernel time of a decode step, all 8
        slots live, its ticks replayed as graphs or run uncaptured: 16 steps
        timed with a sync at the end, then 16 replayed (4, or one tick of 8,
        uncaptured: that trace holds the host ops of every launch) under
        torch.profiler."""
        batcher = paged_batcher(k, eager=eager)
        for r in requests_for(rows, 100_000):
            batcher.submit(r)
        n_calls = max(1, 16 // k)
        for _ in range(max(1, 8 // k)):  # admission + warm-up
            batcher.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_calls):
            batcher.step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / (n_calls * k) * 1e3
        n_prof = max(1, 4 // k) if eager else n_calls
        kern, idle = device_kernels(batcher.step, torch, n_prof)
        mode = "eager" if eager else "graph"
        if not kern:
            log(f"[serve k={k}] step profile, {mode}: {host_ms:.3f} ms a step on the host clock; "
                f"the profiler trace holds no device events (device ms not measured)")
            return
        steps = n_prof * k
        busy_ms = sum(us for us, _ in kern.values()) / steps / 1e3
        top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:6]
        log(f"[serve k={k}] step profile, {mode}: {host_ms:.3f} ms a step on the host clock (no "
            f"profiler), "
            f"{busy_ms:.3f} ms of device kernels a step ({sum(c for _, c in kern.values()) / steps:.0f} "
            f"kernels); device idle in the trace {100 * idle:.1f}% (profiler on), 1 - device / host "
            f"ms {100 * (1 - busy_ms / host_ms):.1f}% (two runs); by kernel (us a step, "
            f"launches a step): " + "; ".join(
                f"{name[:40]} {us / steps:.1f} ({c / steps:.0f})" for name, (us, c) in top))

    # in turns: the host's speed drifts within a run
    for k, eager in ((1, False), (1, True), (8, True), (8, False), (1, False), (1, True)):
        step_profile(k, eager)
        torch.cuda.empty_cache()

    # ---------------------------------------------------------- 10. serve, pressure
    n_pool = PRESSURE_FREE_PAGES + 1
    batcher = paged_batcher(num_pages=n_pool, alloc_watermark=0)
    zero_counts()
    t0 = time.time()
    with CallCount(internlm2, ("prefill", "prefill_with_prefix")) as pre:
        for r in requests_for(rows, PRESSURE_NEW_TOKENS):
            batcher.submit(r)
        done = batcher.run()
    torch.cuda.synchronize()
    check_done("pressure", done, len(rows), batcher, n_pool)
    check_norms("pressure", read_counts(), L, sum(pre.n.values()) + decode_steps())
    log(f"[pressure] {PRESSURE_FREE_PAGES} free pages for {len(rows)} requests of 28 + 2 pages: "
        f"{batcher.n_preempted} preemptions, {batcher._admit_seq} admissions, tokens per request "
        f"{[len(r.tokens) for r in sorted(done, key=lambda r: r.uid)]}, errors "
        f"{[r.error for r in done if r.error]}, {time.time() - t0:.3f} s")
    if batcher.n_preempted < 1:
        fail("[pressure] the pool was not oversubscribed: no preemption")
    del batcher
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 11. serve, HTTP
    batcher = paged_batcher()
    zero_counts()
    http_shapes = ShapeLog(kernels)
    http_shapes.__enter__()  # the scheduler thread launches through the logging wrappers
    http_pre = CallCount(internlm2, ("prefill", "prefill_with_prefix")).__enter__()
    server, loop = http_server.serve_http(engine, batcher, port=0, model_name="callireader-8b")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    t0 = time.time()
    try:
        with opener.open(f"http://127.0.0.1:{port}/health", timeout=60) as r:
            health = json.loads(r.read())
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/chat/completions", method="POST",
            headers={"Content-Type": "application/json"},
            data=json.dumps({"messages": [{"role": "user", "content": "你好"}],
                             "max_tokens": 8}).encode())
        with opener.open(req, timeout=300) as r:
            chat = json.loads(r.read())
        sessions = [loop.submit({"question": QUESTION, "image": pg, "max_new_tokens": 16},
                                stream=False) for pg in serve_pages[:2]]
        ocr = [sess.events.get(timeout=600) for sess in sessions]
        snap = loop.snapshot()
    finally:
        server.shutdown()
        loop.shutdown()
        server.server_close()
        thread.join(timeout=60)
        http_pre.__exit__()
        http_shapes.__exit__()
    http_launches = read_counts()
    if thread.is_alive() or loop._thread.is_alive():
        fail("[http] a server thread did not stop")
    if health.get("status") != "ok" or health.get("slots_total") != SERVE_SLOTS:
        fail(f"[http] /health says {health}")
    if chat["usage"]["completion_tokens"] < 1 or not isinstance(
            chat["choices"][0]["message"]["content"], str):
        fail(f"[http] bad completion {chat}")
    if any(kind != "done" or info["completion_tokens"] < 1 for kind, info in ocr):
        fail(f"[http] a page request failed: {ocr}")
    if snap["requests_completed"] != 3 or len(batcher.pool.free) != SERVE_SLOTS * SERVE_PAGES_PER_SLOT:
        fail(f"[http] counters {snap}, free pages {len(batcher.pool.free)}")
    missing = [n for n in serve_path if http_launches[n] == 0]
    if missing or http_launches["flash_decode"]:
        fail(f"[http] kernels never launched behind the HTTP server: {missing}; launches {http_launches}")
    check_norms("http", http_launches, L, sum(http_pre.n.values()) + decode_steps())
    log(f"[http] /health ok; text completion {chat['usage']}; 2 pages through SchedulerLoop.submit: "
        f"{[(i['prompt_tokens'], i['completion_tokens'], i['finish_reason']) for _, i in ocr]}; "
        f"{time.time() - t0:.3f} s; launches {http_launches}")
    del batcher, loop, server
    torch.cuda.empty_cache()

    # the contiguous scheduler, briefly: its decode goes through flash_decode
    def contiguous_run(max_new, k=1, eager=False):
        """Two requests through a fresh ContinuousBatcher -> (tokens by uid,
        launches, decode steps, prefills, shapes); counts zeroed before."""
        cont = serving.ContinuousBatcher(llm, cfg, num_slots=2, max_len=512, policy=engine.policy,
                                         steps_per_sync=k, eager=eager)
        zero_counts()
        with ShapeLog(kernels) as shp, \
                CallCount(internlm2, ("prefill", "prefill_with_prefix")) as pre:
            for uid in range(2):
                row = rows[uid][-(100 + 28 * uid):]
                cont.submit(serving.Request(uid, row.float().cpu().numpy(), max_new_tokens=max_new,
                                            eos_token_ids=eos))
            done = cont.run()
        if len(done) != 2 or any(r.error or not all(0 <= t < vocab for t in r.tokens) for r in done):
            fail(f"[contiguous] {[(r.tokens, r.error) for r in done]}")
        if not eager and not cont._tick.captured:
            fail("[contiguous] the ticks were not captured")
        return ({r.uid: r.tokens for r in done}, read_counts(), decode_steps(), sum(pre.n.values()),
                shp)

    _, cont_launches, n_dec, n_pre, cont_shapes = contiguous_run(4)
    if cont_launches["flash_decode"] != L * n_dec or n_dec < 1 or cont_launches["paged_flash_decode"]:
        fail(f"[contiguous] launches {cont_launches}, {n_dec} decode steps")
    log(f"[contiguous] ContinuousBatcher: 2 requests, {n_dec} multislot decode steps, launches "
        f"{cont_launches}")
    check_norms("contiguous", cont_launches, L, n_pre + n_dec)
    for k in (1, 8):  # the graphed ticks against the same ticks run uncaptured
        graphed, eager_run = (contiguous_run(CONT_NEW_TOKENS, k, e)[:3] for e in (False, True))
        if graphed != eager_run:
            fail(f"[contiguous k={k}] the graphed ticks gave other tokens or launches than the "
                 f"eager ones: {graphed} / {eager_run}")
        log(f"[contiguous k={k}] graphed ticks = eager ticks: 2 requests x {CONT_NEW_TOKENS} token "
            f"ids, {graphed[2]} decode steps and every kernel's launches equal")

    # ---------------------------------------------------------- 12. reference, paged step
    class Recorded:
        """Wraps a function: keeps the arguments and the result of its last
        call, or (``replay``) returns a kept result without calling it."""

        def __init__(self, fn, replay=None):
            self.fn, self.replay = fn, replay

        def __call__(self, *a, **kw):
            if self.replay is not None:
                return self.replay
            self.args, self.kwargs = a, kw
            self.result = self.fn(*a, **kw)
            return self.result

    def paged_first_step(n_rows):
        """``n_rows`` page requests into a batcher of the serve sizes, one
        step(): admission (one prefill) and the first paged decode step ->
        the active slots' logits after that step."""
        b = paged_batcher()
        for r in requests_for(rows[:n_rows], 4):
            b.submit(r)
        b.step()
        live = [s for s, r in enumerate(b.slot_req) if r is not None]
        if len(live) != n_rows:
            fail(f"[serve] reference check: {len(live)} of {n_rows} rows live after one step")
        return b.last_logits[live].clone()

    def rel_err(a, b):
        return ((a[:, :vocab] - b[:, :vocab]).abs().max() / b[:, :vocab].abs().max()).item()

    plain_all = dict(plain_attention, **plain_int8)
    prefill_k = Recorded(internlm2.prefill)
    with Swap(internlm2, prefill=prefill_k):
        lg1_k = paged_first_step(3)
    lg0_k = prefill_k.result[0]
    # the plain-version model: its admission prefill on the same rows, then
    # its decode step from the kernels' admission (same pools, same tokens)
    with torch.inference_mode(), Swap(internlm2, **plain_all), Swap(k_rms, **plain_rms):
        lg0_p = internlm2.prefill(*prefill_k.args, **prefill_k.kwargs)[0]
    with Swap(internlm2, prefill=Recorded(None, replay=prefill_k.result), **plain_all), \
            Swap(paged_cache, paged_flash_decode=k_paged.paged_flash_decode_reference), \
            Swap(k_rms, **plain_rms):
        zero_counts()
        lg1_p = paged_first_step(3)
        if any(read_counts().values()):
            fail(f"[serve] the plain-version step launched kernels: {read_counts()}")
    paged_rel = max(rel_err(lg0_k, lg0_p), rel_err(lg1_k, lg1_p))
    log(f"[serve] reference check: 3 rows into {SERVE_SLOTS} slots x {SERVE_PAGES_PER_SLOT} pages, "
        f"admission prefill logits rel err {rel_err(lg0_k, lg0_p):.3e}, first paged decode step "
        f"{rel_err(lg1_k, lg1_p):.3e} (every kernel against its plain version)")
    if not paged_rel <= 5e-2:
        fail("the paged decode step through the kernels disagrees with the plain-version model")
    del prefill_k, lg0_k, lg0_p, lg1_k, lg1_p
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 13. kernels of the serve paths
    for path, shp, lch in (("serve", serve1.shapes, serve1.launches),
                           ("http", http_shapes, http_launches),
                           ("contiguous", cont_shapes, cont_launches)):
        attention_rows(path, shp, lch)
        counts = int8_rows(path, shp, lch)
        log(f"[{path}] int8 launches by projection and rows: "
            + ", ".join(f"{label} M={M}: {n}" for (label, M), n in counts.items()))
        if path == "serve":  # every decode step runs all 8 slots' rows, and so did the one prefill
            want = {**{(label, SERVE_SLOTS): L * serve1.n_dec for label in ("wqkv", "wo", "w13", "w2")},
                    ("lm_head", SERVE_SLOTS): serve1.n_dec + 1}
            if counts != want:
                fail(f"[serve] int8 launches by projection and rows {counts}, expected {want}")

    # ---------------------------------------------------------- 20-21. bench, W8A8
    phase("20-21 bench, W8A8")
    bench_phase(h, engine, batch_path)
    w8a8_phase(h, engine)
    # ---------------------------------------------------------- 29. the parallel layer
    phase("29 parallel")
    parallel_phase(h, engine, batch_path)

    # ---------------------------------------------------------- 14-16. training
    phase("14-16 train")
    ahead_8b = draw_8b_ahead()  # phase 30's 8b host draws, made during phases 14-28
    work = tempfile.mkdtemp(prefix="chip_smoke_eit_")
    try:
        data = write_eit_data(engine, work)
        # free the int8 engine: the trainer builds the bf16 8b model
        del engine, llm, layers, rows, serve1, http_shapes, cont_shapes, q, s, got, qp, sp
        gc.collect()
        torch.cuda.empty_cache()
        log(f"int8 engine freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")
        final_dir, post = train_phases(h, data)
        gc.collect()
        torch.cuda.empty_cache()
        # ------------------------------------------------------ 24. post-training
        phase("24 post-train")
        ahead = tile_ahead()  # phase 23's host tiles, made during phases 24 and 17-18
        post_training_phase(h, post, work)
        del post
        gc.collect()
        torch.cuda.empty_cache()
        phase("17-18 CLI")
        cli_phases(h, final_dir, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    # ---------------------------------------------------------- 23. the evaluation harness
    phase("23 evaluate")
    crops, size, char_crops_s = evaluate_phase(h, ahead)
    gc.collect()
    torch.cuda.empty_cache()
    # ---------------------------------------------------------- 25-27. char prep, library models, trainers
    phase("25 char prep")
    charprep_phase(h, crops, size, char_crops_s)
    del crops
    phase("26 llava, moe")
    library_models_phase(h)
    gc.collect()
    torch.cuda.empty_cache()
    phase("27 trainers")
    trainers_phase(h)
    gc.collect()
    torch.cuda.empty_cache()
    # ---------------------------------------------------------- 28. the CalliAlign trainer
    phase("28 callialign")
    callialign_phase(h)
    gc.collect()
    torch.cuda.empty_cache()
    # ---------------------------------------------------------- 30. the measurement scripts
    phase("30 scripts")
    scripts_phase(h, ahead_8b)
    gc.collect()
    torch.cuda.empty_cache()
    # ---------------------------------------------------------- 31. the MLA-MoE LLM
    phase("31 mla-moe")
    moonlight_phase(h)
    gc.collect()
    torch.cuda.empty_cache()
    # ---------------------------------------------------------- 19. RMSNorm at every path's shapes
    phase("19 norms")
    norm_rows(h)
    phase(None)
    emit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
