"""GPU smoke run of the PyTorch/CUDA port (bdm_db1_tpu_torch) on one card.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases build,kernels
    python3 chip_smoke.py --phases build,kernels,eval_loss
    python3 chip_smoke.py --phases build,kernels,train

Phases, each printing one JSON line:

* ``build``      — nvcc builds every CUDA source of the port's main paths
  (one nvcc per source, all started together).
* ``kernels``    — each kernel against its plain PyTorch version at the
  db1_1p2b serving and evaluation shapes and at one small ragged shape,
  with its time, its bound, the plain version's time and one PyTorch
  library call's time as a yardstick: K1/K2 on a bf16 cache (B = 40), K6/K7
  on an int8 cache with scales made by ``quantize_kv_rows`` (B = 56), K8
  equal to K7 on the transposed scales (M = 1024, H = 16, Dh = 128; Q = 19
  and 26 for the primes; a layer index other than 0), K9 at the four trunk
  matrices and the four row counts of the int8 serve (56, 1064, 1456,
  14336: timed, two calls bitwise equal at 56 and 1064 rows) and at 24
  untimed edge shapes (a K split with a shorter last split among them),
  the host time of a K9 call, the W8A8 int32 product against the exact
  one, and K3 (out, m, l) at the validation
  forward's shape (B 4, qlen = klen = 1024, causal), the memory trunk's
  (B 4, qlen 256, klen 1280, same_length window) and a ragged one (B 1,
  qlen 100, klen 1124); K4 and K5 (the six gradients of the rel-attention
  backward) at the same three shapes from a seeded upstream gradient.
* ``serve``      — db1_1p2b in bf16 with random weights from a seed serves
  40 lockstep HalfCheetah-geometry envs (17 obs tokens, 6 continuous
  actions) with strict-length expert prompts through the port's
  ``evaluate_envs_lockstep``; checks the kernels' launch counts against the
  chunk plan, the action tokens' range, and, layer by layer, the kernel
  route against the plain ring branch on one prime and one single-token
  forward; reads how far bf16 moves each layer from an f32 copy.
* ``serve_int8`` — the same at 56 envs with the int8 ring cache and int8
  trunk weights (decode_cache_dtype = decode_weight_dtype = "int8", bf16
  activations, one cohort): K6, K7 and K9 launches against the plan (K9
  also by row count), the action range, and the layer-by-layer route
  check on the int8 cache.
* ``eval_loss``  — the validation loss of db1_1p2b in bf16 (random weights
  from a seed) over 8 micro-batches of 4 x 1024 tokens: packed
  ``RLFullDataset`` samples (prompts on) of a seeded HalfCheetah-geometry
  ``FakeContinuousEnv`` dataset, its valid split, through
  ``SequentialSampler``, ``collate_modalities`` and the port's
  ``evaluate_loss``; checks 24 K3 launches per forward, a finite loss, K3
  against ``rel_attention`` layer by layer at the attention output, and the
  loss through both routes; reads tokens/sec, ms per micro-batch and the
  device idle share.
* ``train``      — training of db1_1p2b (bf16 activations, f32 parameters,
  random weights from a seed, the ModelConfig dropout rates, the default
  AdamW chain) on the train split of the same dataset through
  ``RandomSampler``, ``StratifiedGatoLoader`` (micro 4, accum 2: 2 x 4 x
  1024 tokens a step) and the port's ``Trainer.train()``: one warm-up step,
  then 8 counted steps, each ending in a host read of the loss; checks
  K3 = K4 = K5 = 24 x 2 x 8 launches, finite losses (the first near log V,
  the last below it), finite and changed parameters, and a gradient route
  check (layer by layer the six attention gradients through K3-K5 against
  autograd through ``rel_attention``; the whole model's gradient through
  both routes under the same dropout masks); reads tokens/sec, the median
  step, the device idle share and the peak memory.

With ``--old-qmm SRC`` (a copy of an earlier csrc/quant_matmul.cu, e.g.
under build/), the kernels phase also times that K9 in turns with this
tree's (new, old, old, new) and its host time per call. With
``--old-rel-bwd SRC`` (a copy of an earlier
csrc/flash_rel_attention_bwd.cu with the same C interface), it times that
K5 in turns with this tree's (old, new, new, old) on the same inputs at
the two timed K4/K5 shapes.

The ``build`` phase also reads, from nvcc's ``-Xptxas -v`` output, the
registers, stack, spill bytes and static shared memory of K4 and K5.

Then it prints the card's name and power limit (nvidia-smi), one JSON line
with every kernel's numbers and its launches on the main paths (only when
``kernels`` and every main-path phase ran, as with no arguments), and as the
last line ``{"ok": true, "device": {...}}``. Any failure raises: the exit
code is then not 0 and no result line is printed. It needs one CUDA card
and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12        # dense bf16 tensor-core peak
SPIN_CYCLES_PER_S = 1.98e9      # H100 SXM boost clock: time_ms's spin
PHASES = ("build", "kernels", "serve", "serve_int8", "eval_loss", "train")
MAIN_PATHS = ("serve", "serve_int8", "eval_loss", "train")
SOURCES = ("flash_ring_decode", "quant_matmul", "flash_rel_attention",
           "flash_rel_attention_bwd")
# Kernel against its plain version, normalised output: max |diff| at most
# OUT_REL_TOL * max |plain output|. Both round p (times the v scale, int8)
# to bf16 per split before the PV product with the same split maxima, so
# they differ only where an exp lands on the other side of a bf16 rounding:
# a few 2^-9 of one key's weight, about 2e-4 of the largest output. A split
# whose PV is dropped or misweighted moves outputs by a share of their
# size, far above the limit. The int8 cache changes neither side's
# roundings (its values are exact in f32 and bf16), so the limit holds.
OUT_REL_TOL = 2e-3
# K9 against its plain version: max |diff| at most QMM_REL_TOL * max
# |plain|. Both sum the same exact bf16 x int8 products in f32, in another
# order (~1e-6 of the output); a wrong tile, mask or scale moves outputs by
# O(1) of their size.
QMM_REL_TOL = 1e-4


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time per call of fn(i) over ``iters`` calls (CUDA
    events); i lets a caller rotate through layers or copies so no launch
    finds the previous one's bytes in L2. The card first spins for about
    50 µs a call, so the calls are all queued before the first runs and a
    call shorter than its host enqueue is not paced by the host."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(iters * 50e-6, 0.05) * SPIN_CYCLES_PER_S))
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


PTXAS_KERNELS = ("k4_rel_bwd_dq_kernel", "k5_rel_bwd_dkv_kernel")


def ptxas_resources(log: str) -> dict:
    """{kernel: {registers, stack, spill_stores, spill_loads, smem}} from
    nvcc's ``-Xptxas -v`` output (bytes; smem is the static shared memory
    ptxas reports, dynamic shared memory is not in it), for each entry
    function whose mangled name holds one of PTXAS_KERNELS."""
    out = {}
    for chunk in re.split(r"Compiling entry function", log)[1:]:
        name = next((k for k in PTXAS_KERNELS
                     if k in chunk.split("\n", 1)[0]), None)
        if name is None:
            continue
        rec = {}
        m = re.search(r"Used (\d+) registers", chunk)
        if m:
            rec["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", chunk)
        if m:
            rec.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"(\d+) bytes smem", chunk)
        rec["smem"] = int(m.group(1)) if m else 0
        out[name] = rec
    return out


def phase_build() -> dict:
    from bdm_db1_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    built = cuda_build.build_libraries(SOURCES)
    rec = {"phase": "build", "seconds": time.perf_counter() - t0,
           "sources": {k: v["seconds"] for k, v in built.items()}}
    for name, info in built.items():
        # ptxas resource lines (registers, shared memory, spills)
        print(f"[nvcc {name}]\n{info['log'].strip()}", file=sys.stderr)
    if "flash_rel_attention_bwd" in built:
        rec["resources"] = ptxas_resources(
            built["flash_rel_attention_bwd"]["log"])
    return rec


def _cache(gen, L, B, M, H, Dh, int8: bool):
    """(k, v, k_scale, v_scale) of a stacked ring cache from seeded bf16
    values: bf16 with no scales, or int8 with scales [L, B, M, H] made by
    quantize_kv_rows layer by layer."""
    from bdm_db1_tpu_torch.models.transformer_xl import quantize_kv_rows

    if not int8:
        k = torch.randn(L, B, M, H, Dh, device="cuda", generator=gen)
        v = torch.randn(L, B, M, H, Dh, device="cuda", generator=gen)
        return k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
    out = [torch.empty(L, B, M, H, Dh, dtype=torch.int8, device="cuda")
           for _ in range(2)] + [torch.empty(L, B, M, H, device="cuda")
                                 for _ in range(2)]
    for kv in range(2):
        for layer in range(L):
            x = torch.randn(B, M, H, Dh, device="cuda", generator=gen)
            out[kv][layer], out[2 + kv][layer] = quantize_kv_rows(
                x.to(torch.bfloat16))
    return tuple(out)


def _kernel_case(fro, *, L, B, M, H, Dh, Q, layer, seed, timed, int8=False):
    """One ring kernel (K1/K6 when Q is None, else K2/K7, and K8 for an
    int8 prime) against its plain version on the same inputs. Returns the
    comparison and, when timed, the times."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    scale = 1.0 / Dh ** 0.5
    k, v, ks, vs = _cache(gen, L, B, M, H, Dh, int8)
    nq = 1 if Q is None else Q
    qw = torch.randn(B, H, nq, Dh, device=dev, generator=gen).to(torch.bfloat16)
    bias = torch.randn(B, H, nq, M, device=dev, generator=gen) * 0.5
    bias[..., 0] = fro.NEG_INF                    # the oldest ring column
    split = fro.K1_SPLIT if Q is None else fro.K2_SPLIT
    bias[0, 1, :, split:2 * split] = fro.NEG_INF  # one all-banned split
    if Q is None:
        qw, bias = qw[:, :, 0].contiguous(), bias[:, :, 0].contiguous()
        kern, plain = fro.flash_ring_decode, fro.flash_ring_decode_plain
    else:
        kern, plain = fro.flash_ring_prime_ap, fro.flash_ring_prime_ap_plain
    sc = () if ks is None else (ks, vs)

    o, m, l = kern(k, v, qw, bias, layer, *sc, scale=scale)
    torch.cuda.synchronize()
    o_p, m_p, l_p = plain(k, v, qw, bias, layer, *sc, scale=scale,
                          block_m=split)
    torch.cuda.synchronize()
    out = o / l[..., None] if Q is not None else o / l
    out_p = o_p / l_p[..., None] if Q is not None else o_p / l_p
    out_max = float(out_p.abs().max())
    err = float((out - out_p).abs().max())
    m_err = float((m - m_p).abs().max())
    l_rel = float(((l - l_p).abs() / l_p.abs()).max())
    tol = {"out_abs": OUT_REL_TOL * out_max, "m_abs": 1e-3, "l_rel": 1e-3}
    ok = (np.isfinite([err, m_err, l_rel]).all() and err <= tol["out_abs"]
          and m_err <= tol["m_abs"] and l_rel <= tol["l_rel"])
    rec = {"shape": {"L": L, "B": B, "M": M, "H": H, "Dh": Dh, "Q": nq,
                     "layer": layer, "cache": "int8" if int8 else "bf16"},
           "max_abs_err": err, "out_plain_absmax": out_max,
           "m_abs_err": m_err, "l_rel_err": l_rel, "tol": tol, "ok": bool(ok)}
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {rec}")
    k8 = None
    if int8 and Q is not None:
        # K8: the same prime with the scales head-major [L, B, H, M] must
        # give K7's outputs exactly (one kernel, another scale stride)
        ks_t, vs_t = ks.transpose(2, 3).contiguous(), vs.transpose(2, 3).contiguous()
        got = fro.flash_ring_prime(k, v, qw, bias, layer, ks_t, vs_t,
                                   scale=scale)
        torch.cuda.synchronize()
        rec["k8_equals_k7"] = all(torch.equal(a, b)
                                  for a, b in zip(got, (o, m, l)))
        if not rec["k8_equals_k7"]:
            raise AssertionError("K8 on transposed scales differs from K7")
        o8, _, l8 = got
        rec["k8_max_abs_err"] = float((o8 / l8[..., None] - out_p).abs().max())

        def k8(i):
            return fro.flash_ring_prime(k, v, qw, bias, i % L, ks_t, vs_t,
                                        scale=scale)
    if timed:
        elem = 1 if int8 else 2
        cache_bytes = 2 * B * M * H * Dh * elem + (2 * B * M * H * 4 if int8
                                                   else 0)
        io_bytes = (qw.numel() * 2 + bias.numel() * 4
                    + B * H * nq * Dh * 4 + 2 * B * H * nq * 4)
        rec.update(bound(cache_bytes + io_bytes, 2 * 2 * B * H * nq * M * Dh))
        rec["ms"] = time_ms(lambda i: kern(
            k, v, qw, bias, i % L, *sc,
            scale=scale), iters=48)
        if k8 is not None:
            rec["k8_ms"] = time_ms(k8, iters=48)
        rec["plain_ms"] = time_ms(lambda i: plain(
            k, v, qw, bias, i % L, *sc,
            scale=scale, block_m=split), iters=6, warmup=1)
        # yardstick only: one PyTorch call computing the normalised output
        # of the same attention (the port never calls it); an int8 cache is
        # dequantized to bf16 beforehand, outside the timing, for 4 layers
        qs = (qw if Q is not None else qw[:, :, None])
        mask = (bias if Q is not None else bias[:, :, None]).to(torch.bfloat16)
        if int8:
            from bdm_db1_tpu_torch.models.transformer_xl import dequantize_kv

            lib_layers = [(dequantize_kv(k[j], ks[j], torch.bfloat16),
                           dequantize_kv(v[j], vs[j], torch.bfloat16))
                          for j in range(min(4, L))]
        else:
            lib_layers = [(k[j], v[j]) for j in range(L)]

        def lib(i):
            kl, vl = lib_layers[i % len(lib_layers)]
            return F.scaled_dot_product_attention(
                qs, kl.permute(0, 2, 1, 3), vl.permute(0, 2, 1, 3),
                attn_mask=mask, scale=scale)

        rec["library_ms"] = time_ms(lib, iters=12, warmup=2)
        rec["library"] = "F.scaled_dot_product_attention" + (
            " over the dequantized bf16 cache" if int8 else "")
    return rec


# the trunk matrices (K, N) of db1_1p2b: qkv_net, o_net, CoreNet.0, .2
TRUNK = {"qkv_net": (2048, 6144), "o_net": (2048, 2048),
         "CoreNet.0": (2048, 8192), "CoreNet.2": (4096, 2048)}
# K9's rows in the int8 serve: 56 envs x q = 1, 19 (steady prime), 26
# (the prompt's tail slice), 256 (a prompt slice)
QMM_ROWS = (56, 1064, 1456, 14336)
# K9's untimed edge shapes: rows around the one-tile limit (64) and past
# it, ragged N, a K tail of half a step (96, 4128 = 64.5 x 64); 56 x 4128
# x 2056 splits K 4 ways with a shorter last split
QMM_EDGE = [(R, K, N) for R in (1, 8, 57, 64, 65, 200) for K in (96, 4128)
            for N in (200, 2056)]


def _build_copy(src: str):
    """nvcc (the port's flags) on a copy of an earlier CUDA source, next to
    it: (the loaded library, nvcc's output)."""
    import ctypes
    import os
    from pathlib import Path

    from bdm_db1_tpu_torch.ops import cuda_build

    src = Path(src).resolve()
    out = src.with_suffix(".so")
    log = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                          str(out), str(src)], capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{log.stdout}"
                           f"{log.stderr}")
    return ctypes.CDLL(os.fspath(out)), log.stdout + log.stderr


class OldQmm:
    """An earlier K9 kernel with the 9-argument C interface (the wmma,
    cp.async-ring one), built from a copy of its source given by
    --old-qmm and called as its wrapper called it: timed in turns with the
    kernel of this tree on the same card. Not part of the port."""

    def __init__(self, src: str):
        import ctypes

        self.lib, _ = _build_copy(src)
        P, I = ctypes.c_void_p, ctypes.c_int
        self.lib.bdm_quant_matmul.argtypes = [P] * 4 + [I] * 4 + [P]
        self.lib.bdm_quant_matmul.restype = I

    def __call__(self, x, w_q, scale):
        from bdm_db1_tpu_torch.ops.cuda_build import check_operand

        R, K = x.shape
        N = w_q.shape[0]
        dev = x.device
        check_operand("x", x, (R, K), torch.bfloat16, dev)
        check_operand("w_q", w_q, (N, K), torch.int8, dev)
        check_operand("scale", scale, (N,), torch.float32, dev)
        y = torch.empty(R, N, device=dev, dtype=torch.float32)
        rc = self.lib.bdm_quant_matmul(
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), y.data_ptr(), R,
            K, N, dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"old K9 launch failed ({rc})")
        return y


class OldRelBwd:
    """An earlier K4/K5 source with this tree's C interface, built from a
    copy given by --old-rel-bwd and called through the port's own wrapper
    (``_launch_bwd``) with its library in place of this tree's: timed in
    turns with this tree's K5 on the same card. Not part of the port."""

    def __init__(self, src: str):
        import ctypes

        from bdm_db1_tpu_torch.ops import flash_rel_attention as fra

        lib, log = _build_copy(src)
        self.resources = ptxas_resources(log)
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bdm_flash_rel_attention_bwd.argtypes = (
            [I] + [P] * 18 + [LL] * 6 + [I] * 6 + [ctypes.c_float, I, P])
        lib.bdm_flash_rel_attention_bwd.restype = I
        lib.bdm_rel_bwd_error_string.argtypes = [I]
        lib.bdm_rel_bwd_error_string.restype = ctypes.c_char_p
        self.lib, self.fra = lib, fra

    def __call__(self, which, *args):
        fra = self.fra
        current = fra._lib_bwd
        fra._lib_bwd = lambda: self.lib
        try:
            return fra._launch_bwd(which, *args)
        finally:
            fra._lib_bwd = current


def _qmm_case(qm, *, R, K, N, seed, timed, old=None):
    """K9 against its plain version on one weight made by quantize_weight
    from seeded values, with its plan; at 56 and 1064 rows two calls must
    agree bit for bit. When timed, its time, bound, plain time and the time
    of F.linear on the pre-dequantized bf16 weight; with ``old``, the old
    kernel and this one timed in turns (new, old, old, new)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w_q, s = qm.quantize_weight(
        torch.randn(N, K, device="cuda", generator=gen) * 0.02)
    x = torch.randn(R, K, device="cuda", generator=gen).to(torch.bfloat16)
    y = qm.quant_matmul(x, w_q, s)
    torch.cuda.synchronize()
    y_p = qm.quant_matmul_plain(x, w_q, s)
    torch.cuda.synchronize()
    err = float((y - y_p).abs().max())
    ymax = float(y_p.abs().max())
    plan = qm.plan_quant_matmul(R, K, N)
    rec = {"shape": {"R": R, "K": K, "N": N}, "max_abs_err": err,
           "out_plain_absmax": ymax, "tol": QMM_REL_TOL * ymax,
           "plan": {"bn": plan.bn, "bm": plan.bm, "split": plan.split,
                    "kps": plan.kps, "nk": plan.nk, "ctas": plan.ctas},
           "ok": bool(np.isfinite(err) and err <= QMM_REL_TOL * ymax)}
    if R in (56, 1064):
        rec["bitwise_repeat"] = bool(torch.equal(y, qm.quant_matmul(x, w_q,
                                                                    s)))
        rec["ok"] = rec["ok"] and rec["bitwise_repeat"]
    if not rec["ok"]:
        raise AssertionError(f"K9 disagrees with its plain version or "
                             f"with itself: {rec}")
    if timed:
        rec.update(bound(R * K * 2 + N * K + N * 4 + R * N * 4,
                         2 * R * K * N))
        # >= 128 MB of weights between two reads of one copy (50 MB L2)
        n = max(1, min(16, -(-(1 << 27) // (N * K))))
        wqs = [w_q] + [w_q.clone() for _ in range(n - 1)]
        iters = 200 if R <= 64 else 50 if R <= 2048 else 10
        turns = [qm.quant_matmul] + ([old, old, qm.quant_matmul] if old
                                     else [])
        times = [time_ms(lambda i, f=f: f(x, wqs[i % n], s), iters=iters)
                 for f in turns]
        rec["ms"] = float(np.mean(times[::3]))
        if old:
            y_o = old(x, w_q, s)
            torch.cuda.synchronize()
            rec["old_max_abs_err"] = float((y_o - y_p).abs().max())
            rec["old_ms"] = float(np.mean(times[1:3]))
            rec["turns_ms"] = times
        rec["plain_ms"] = time_ms(lambda i: qm.quant_matmul_plain(
            x, wqs[i % n], s), iters=3, warmup=1)
        w_bf = [(c.float() * s[:, None]).to(torch.bfloat16) for c in wqs]
        rec["library_ms"] = time_ms(lambda i: F.linear(x, w_bf[i % n]),
                                    iters=iters)
        rec["library"] = "F.linear, bf16 weight dequantized beforehand"
    return rec


def _qmm_host_us(qm, old=None, calls: int = 1000) -> dict:
    """Host time a K9 call takes to enqueue (wrapper, plan, ctypes,
    launch), µs: ``calls`` calls at 56 x 2048 x 2048 without a sync (the
    card takes less time a call than the host, so the host clock reads the
    enqueue); with ``old``, the old wrapper's the same way, in three rounds
    of turns (new, old, old, new): the host is shared and noisy."""
    gen = torch.Generator(device="cuda").manual_seed(70)
    w_q, s = qm.quantize_weight(
        torch.randn(2048, 2048, device="cuda", generator=gen) * 0.02)
    x = torch.randn(56, 2048, device="cuda", generator=gen).to(torch.bfloat16)
    out = {}
    new = ("new", qm.quant_matmul)
    turns = [new, ("old", old), ("old", old), new] * 3 if old else [new]
    for name, f in turns:
        for _ in range(10):
            f(x, w_q, s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            f(x, w_q, s)
        out.setdefault(name, []).append(
            (time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return {"shape": {"R": 56, "K": 2048, "N": 2048}, "calls": calls,
            **{f"{k}_us": v for k, v in out.items()},
            **{f"{k}_us_median": float(np.median(v)) for k, v in out.items()}}


def _w8a8_check(qm) -> list:
    """W8A8's int8 x int8 -> int32 product (torch._int_mm) against the
    exact integer product (f64 on the card: |acc| <= K * 127^2 < 2^53)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = []
    for R, K, N in ((56, 2048, 6144), (1064, 4096, 2048), (5, 96, 40)):
        xq = torch.randint(-127, 128, (R, K), device="cuda", generator=gen,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (N, K), device="cuda", generator=gen,
                           dtype=torch.int8)
        acc = qm.int8_matmul(xq, wq)
        exact = xq.double() @ wq.double().t()
        ok = acc.dtype == torch.int32 and torch.equal(acc.double(), exact)
        out.append({"shape": [R, K, N], "exact": bool(ok)})
        if not ok:
            raise AssertionError(f"W8A8 int32 product is not exact: {out}")
    return out


# K3 against its plain version. out is bf16 on both sides: where the two
# f32 results straddle a bf16 rounding boundary they differ by one ulp of
# the element (at most 2^-7 of it), so each element may differ by that plus
# OUT_REL_TOL * max |plain|, the ring kernels' limit for the softmax itself
# (p rounded to bf16 per key tile with the running max against once with
# the final max). The f32 row stats hold the mask: one key wrongly in or out
# of a row moves l by ~1/n of it (>= 1e-3 at n <= 1024) and m by a score,
# while both sides sum the same f32 products in another order (~1e-6).
K3_M_ABS_TOL = 1e-4
K3_L_REL_TOL = 1e-4
# K4/K5 against their plain version: each gradient's max |diff| at most
# BWD_REL_TOL of its largest value. dq, dk, dv and drk are bf16 on both
# sides (the kernels round p and dS to bf16 for the tensor-core products,
# the plain version does not), so they differ by about one bf16 ulp of an
# element, at most 2^-7 = 7.8e-3 of the largest; drk's f32 atomics add in
# another order every run. drw and drr are f32 sums of the same f32 terms
# in another order. Readings on an H100 80GB HBM3 (700 W) over the three
# shapes: dq 5.3e-3, dk 4.1e-3, dv 5.1e-3, drk 7.7e-3, drw 1.3e-6, drr
# 1.4e-6. A wrong mask, shift, scale or band row moves a gradient by O(1)
# of its size.
BWD_REL_TOL = {"dq": 2e-2, "dk": 2e-2, "dv": 2e-2, "drk": 2e-2,
               "drw": 1e-4, "drr": 1e-4}


def _rel_case(fra, *, B, qlen, klen, mem_len, same_length, seed, timed):
    """K3 on q, k, v sliced from one fused [B, klen, 3 * H * Dh] projection
    (as the trunk feeds it, through its strides) against its plain version:
    (out, m, l); when timed, its time, bound, plain time and the time of
    F.scaled_dot_product_attention on the same function."""
    from bdm_db1_tpu_torch.ops.attention import (
        causal_mask, rel_shift_sliced, same_length_mask,
    )

    H, Dh = 16, 128
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, klen, 3 * H * Dh, device="cuda",
                      generator=gen).to(torch.bfloat16)
    q, k, v = qkv.split(H * Dh, dim=-1)
    q = q[:, -qlen:].unflatten(-1, (H, Dh))
    k, v = k.unflatten(-1, (H, Dh)), v.unflatten(-1, (H, Dh))
    rk = torch.randn(klen, H, Dh, device="cuda",
                     generator=gen).to(torch.bfloat16)
    rw = torch.randn(H, Dh, device="cuda", generator=gen) * 0.1
    rr = torch.randn(H, Dh, device="cuda", generator=gen) * 0.1
    kw = dict(mem_len=mem_len, same_length=same_length, scale=1.0 / Dh ** 0.5)
    args = (q, k, v, rk, rw, rr)
    out, (m, l) = fra.flash_rel_attention(*args, with_stats=True, **kw)
    torch.cuda.synchronize()
    out_p, m_p, l_p = fra.flash_rel_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    diff = (out.float() - out_p.float()).abs()
    out_max = float(out_p.float().abs().max())
    excess = float((diff - 2.0 ** -7 * out_p.float().abs()
                    - OUT_REL_TOL * out_max).max())
    err = float(diff.max())
    m_err = float((m - m_p).abs().max())
    l_rel = float(((l - l_p).abs() / l_p.abs()).max())
    ok = (np.isfinite([err, m_err, l_rel]).all() and excess <= 0
          and m_err <= K3_M_ABS_TOL and l_rel <= K3_L_REL_TOL)
    rec = {"shape": {"B": B, "qlen": qlen, "klen": klen, "H": H, "Dh": Dh,
                     "mem_len": mem_len, "same_length": same_length},
           "max_abs_err": err, "out_plain_absmax": out_max,
           "err_over_limit_max": excess, "m_abs_err": m_err,
           "l_rel_err": l_rel,
           "tol": {"out": "2^-7 |plain| + %g max|plain|" % OUT_REL_TOL,
                   "m_abs": K3_M_ABS_TOL, "l_rel": K3_L_REL_TOL},
           "ok": bool(ok)}
    if not ok:
        raise AssertionError(f"K3 disagrees with its plain version: {rec}")
    if timed:
        banned = (same_length_mask(qlen, klen, mem_len, device="cuda")
                  if same_length else causal_mask(qlen, klen, device="cuda"))
        pairs = int((~banned).sum()) * B * H
        # q, k, v, o and rk once each in bf16, the f32 stats and biases
        nbytes = 2 * (2 * B * qlen + 2 * B * klen + klen) * H * Dh \
            + 4 * (2 * B * H * qlen + 2 * H * Dh)
        rec.update(bound(nbytes, 3 * 2 * Dh * pairs))
        rec["unbanned_pairs"] = pairs
        rec["ms"] = time_ms(lambda i: fra.flash_rel_attention(*args, **kw),
                            iters=20)
        rec["plain_ms"] = time_ms(lambda i: fra.flash_rel_attention_plain(
            *args, **kw), iters=3, warmup=1)
        # yardstick only (the port never calls it): SDPA of (q + r_w) over
        # k, v with the scaled BD term and -inf at banned positions as its
        # float mask, built beforehand outside the timing, so the library
        # time leaves out the BD product and the mask that K3 computes
        qw = (q.float() + rw).to(torch.bfloat16).transpose(1, 2)
        bd = torch.einsum("bihd,jhd->bhij", q.float() + rr, rk.float())
        mask = torch.where(banned, float("-inf"), rel_shift_sliced(bd)
                           * kw["scale"]).to(torch.bfloat16)
        del bd
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        rec["library_ms"] = time_ms(lambda i: F.scaled_dot_product_attention(
            qw, kt, vt, attn_mask=mask, scale=kw["scale"]), iters=10)
        rec["library"] = ("F.scaled_dot_product_attention of q + r_w with "
                          "the scaled BD term as a bf16 mask built "
                          "beforehand (undercounts the whole function)")
    return rec


GRAD_NAMES = ("dq", "dk", "dv", "drk", "drw", "drr")


def _rel_bwd_case(fra, *, B, qlen, klen, mem_len, same_length, seed, timed,
                  old=None):
    """K4 and K5 on K3's inputs (q, k, v sliced from one fused projection),
    K3's (out, m, l) and a seeded upstream gradient, against their plain
    version: the six gradients, each within BWD_REL_TOL of its largest
    value; when timed, each kernel's time and bound, the plain backward's
    time and the SDPA backward as a yardstick; with ``old`` (OldRelBwd),
    the old K5 and this one timed in turns (old, new, new, old), the old
    one's five gradients held to this one's within twice BWD_REL_TOL."""
    from bdm_db1_tpu_torch.ops.attention import rel_shift_sliced

    H, Dh = 16, 128
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, klen, 3 * H * Dh, device="cuda",
                      generator=gen).to(torch.bfloat16)
    q, k, v = qkv.split(H * Dh, dim=-1)
    q = q[:, -qlen:].unflatten(-1, (H, Dh))
    k, v = k.unflatten(-1, (H, Dh)), v.unflatten(-1, (H, Dh))
    rk = torch.randn(klen, H, Dh, device="cuda",
                     generator=gen).to(torch.bfloat16)
    rw = torch.randn(H, Dh, device="cuda", generator=gen) * 0.1
    rr = torch.randn(H, Dh, device="cuda", generator=gen) * 0.1
    dout = torch.randn(B, qlen, H, Dh, device="cuda",
                       generator=gen).to(torch.bfloat16)
    kw = dict(mem_len=mem_len, same_length=same_length, scale=1.0 / Dh ** 0.5)
    args = (q, k, v, rk, rw, rr)
    with torch.no_grad():
        out, (m, l) = fra.flash_rel_attention(*args, with_stats=True, **kw)
    saved = args + (out, m, l, dout)
    pos = (mem_len, same_length, kw["scale"])
    got = (fra._launch_bwd("dq", *saved, *pos),) + \
        fra._launch_bwd("dkv", *saved, *pos)
    torch.cuda.synchronize()
    ref = fra.flash_rel_attention_bwd_plain(*saved, **kw)
    torch.cuda.synchronize()
    rel, abs_err = {}, {}
    for name, a, b in zip(GRAD_NAMES, got, ref):
        abs_err[name] = float((a.float() - b.float()).abs().max())
        rel[name] = abs_err[name] / float(b.float().abs().max())
    del ref
    ok = all(np.isfinite(rel[n]) and rel[n] <= BWD_REL_TOL[n]
             for n in GRAD_NAMES)
    rec = {"shape": {"B": B, "qlen": qlen, "klen": klen, "H": H, "Dh": Dh,
                     "mem_len": mem_len, "same_length": same_length},
           "rel_err": rel, "abs_err": abs_err, "tol": BWD_REL_TOL,
           "ok": bool(ok)}
    if not ok:
        raise AssertionError(f"K4/K5 disagree with their plain version: {rec}")
    if timed:
        banned = fra._banned(qlen, klen, mem_len, same_length, "cuda")
        pairs = int((~banned).sum()) * B * H
        rows_q, rows_k = B * qlen * H * Dh, B * klen * H * Dh
        stats = 3 * 4 * B * H * qlen                   # m, l, delta
        ins = 2 * (2 * rows_q + 2 * rows_k + klen * H * Dh) + stats \
            + 2 * 4 * H * Dh
        rec["dq"] = bound(ins + 2 * rows_q, 5 * 2 * Dh * pairs)
        rec["dkv"] = bound(ins + 2 * 2 * rows_k + 4 * klen * H * Dh
                           + 2 * 4 * H * Dh, 6 * 2 * Dh * pairs)
        rec["unbanned_pairs"] = pairs
        rec["dq"]["ms"] = time_ms(
            lambda i: fra._launch_bwd("dq", *saved, *pos), iters=10)

        def new_dkv(i):
            return fra._launch_bwd("dkv", *saved, *pos)

        if old is None:
            rec["dkv"]["ms"] = time_ms(new_dkv, iters=10)
        else:
            def old_dkv(i):
                return old("dkv", *saved, *pos)

            old_rel = {}
            for name, a, b in zip(GRAD_NAMES[1:], old_dkv(0), got[1:]):
                old_rel[name] = float((a.float() - b.float()).abs().max()
                                      / b.float().abs().max())
            torch.cuda.synchronize()
            rec["dkv"]["old_vs_new_rel_err"] = old_rel
            if not all(np.isfinite(v) and v <= 2 * BWD_REL_TOL[n]
                       for n, v in old_rel.items()):
                raise AssertionError(f"the old K5 disagrees with this "
                                     f"one: {old_rel}")
            times = [time_ms(f, iters=10)
                     for f in (old_dkv, new_dkv, new_dkv, old_dkv)]
            rec["dkv"]["ms"] = float(np.mean(times[1:3]))
            rec["dkv"]["old_ms"] = float(np.mean(times[::3]))
            rec["dkv"]["turns_ms"] = times
        rec["plain_ms"] = time_ms(lambda i: fra.flash_rel_attention_bwd_plain(
            *saved, **kw), iters=2, warmup=1)
        # yardstick only (the port never calls it): the backward of SDPA of
        # (q + r_w) over k, v with the scaled BD term and -inf as a float
        # mask built beforehand, over torch.autograd.grad with the forward
        # done first. One number for K4 + K5; it leaves out the BD band
        # gradients (dq_bd, drk, drr), so it undercounts the function.
        qw = (q.float() + rw).to(torch.bfloat16).transpose(1, 2) \
            .detach().requires_grad_(True)
        kt = k.transpose(1, 2).detach().requires_grad_(True)
        vt = v.transpose(1, 2).detach().requires_grad_(True)
        with torch.no_grad():
            bd = torch.einsum("bihd,jhd->bhij", q.float() + rr, rk.float())
            mask = torch.where(banned, float("-inf"), rel_shift_sliced(bd)
                               * kw["scale"]).to(torch.bfloat16)
            del bd
        o = F.scaled_dot_product_attention(qw, kt, vt, attn_mask=mask,
                                           scale=kw["scale"])
        go = dout.transpose(1, 2)
        rec["library_ms"] = time_ms(lambda i: torch.autograd.grad(
            o, (qw, kt, vt), go, retain_graph=True), iters=10)
        rec["library"] = ("backward of F.scaled_dot_product_attention of q + "
                          "r_w with the scaled BD term as a bf16 mask: K4 + "
                          "K5 together, without the BD gradients "
                          "(undercounts the function)")
    return rec


def phase_kernels(old_qmm=None, old_rel_bwd=None) -> dict:
    from bdm_db1_tpu_torch.ops import flash_rel_attention as fra
    from bdm_db1_tpu_torch.ops import flash_ring_decode as fro
    from bdm_db1_tpu_torch.ops import quant_matmul as qm

    full = dict(L=24, B=40, M=1024, H=16, Dh=128, layer=17)
    full8 = dict(full, B=56, int8=True)
    ragged = dict(L=3, B=3, M=200, H=4, Dh=128, layer=2)
    ragged8 = dict(ragged, int8=True)
    cases = {
        "flash_ring_decode": [
            _kernel_case(fro, Q=None, seed=1, timed=True, **full),
            _kernel_case(fro, Q=None, seed=2, timed=False, **ragged)],
        "flash_ring_prime_ap": [
            _kernel_case(fro, Q=19, seed=3, timed=True, **full),
            _kernel_case(fro, Q=26, seed=4, timed=True, **full),
            _kernel_case(fro, Q=5, seed=5, timed=False, **ragged)],
        "flash_ring_decode_int8": [
            _kernel_case(fro, Q=None, seed=11, timed=True, **full8),
            _kernel_case(fro, Q=None, seed=12, timed=False, **ragged8)],
        "flash_ring_prime_ap_int8": [
            _kernel_case(fro, Q=19, seed=13, timed=True, **full8),
            _kernel_case(fro, Q=26, seed=14, timed=True, **full8),
            _kernel_case(fro, Q=5, seed=15, timed=False, **ragged8)],
    }
    torch.cuda.empty_cache()
    old = OldQmm(old_qmm) if old_qmm else None
    qmm = [_qmm_case(qm, R=R, K=K, N=N, seed=20 + i, timed=True, old=old)
           for i, (R, (K, N)) in enumerate(
               (R, kn) for R in QMM_ROWS for kn in TRUNK.values())]
    qmm += [_qmm_case(qm, R=R, K=K, N=N, seed=80 + i, timed=False)
            for i, (R, K, N) in enumerate(QMM_EDGE)]
    if not any(c["plan"]["split"] > 1
               and c["plan"]["split"] * c["plan"]["kps"] > c["plan"]["nk"]
               for c in qmm):
        raise AssertionError("no K9 case ran a split with a shorter last "
                             "split")
    cases["quant_matmul"] = qmm
    host_us = _qmm_host_us(qm, old)
    torch.cuda.empty_cache()
    cases["flash_rel_attention"] = [
        # (a) the validation forward: seq 1024, no memory (causal: the
        # same_length window is empty at klen = mem_len)
        _rel_case(fra, B=4, qlen=1024, klen=1024, mem_len=1024,
                  same_length=True, seed=50, timed=True),
        # (b) the trunk over 1024 memory rows (decode_rl): window active
        _rel_case(fra, B=4, qlen=256, klen=1280, mem_len=1024,
                  same_length=True, seed=51, timed=True),
        # (c) ragged, as the JAX anylen wrapper admits it
        _rel_case(fra, B=1, qlen=100, klen=1124, mem_len=1024,
                  same_length=True, seed=52, timed=False)]
    torch.cuda.empty_cache()
    old_bwd = OldRelBwd(old_rel_bwd) if old_rel_bwd else None
    cases["flash_rel_attention_bwd"] = [
        # (a) the train step's shape: B 4, seq 1024, causal
        _rel_bwd_case(fra, B=4, qlen=1024, klen=1024, mem_len=1024,
                      same_length=True, seed=60, timed=True, old=old_bwd),
        # (b) over 1024 memory rows, window active
        _rel_bwd_case(fra, B=4, qlen=256, klen=1280, mem_len=1024,
                      same_length=True, seed=61, timed=True, old=old_bwd),
        # (c) ragged
        _rel_bwd_case(fra, B=1, qlen=100, klen=1124, mem_len=1024,
                      same_length=True, seed=62, timed=False)]
    rec = {"phase": "kernels", "cases": cases, "qmm_host_us": host_us,
           "w8a8_int32": _w8a8_check(qm)}
    if old_bwd:
        rec["old_rel_bwd_resources"] = old_bwd.resources
    return rec


K_REPLACES = {
    "flash_ring_decode": "bdm_db1_tpu/ops/flash_ring_decode.py:249",
    "flash_ring_prime_ap": "bdm_db1_tpu/ops/flash_ring_decode.py:578",
    "flash_ring_decode_int8": "bdm_db1_tpu/ops/flash_ring_decode.py:166",
    "flash_ring_prime_ap_int8": "bdm_db1_tpu/ops/flash_ring_decode.py:497",
    "flash_ring_prime": "bdm_db1_tpu/ops/flash_ring_decode.py:671",
    "quant_matmul": "bdm_db1_tpu/ops/quant_matmul.py:125",
    "flash_rel_attention": "bdm_db1_tpu/ops/pallas_attention.py:50",
    "flash_rel_attention_bwd_dq": "bdm_db1_tpu/ops/pallas_attention.py:244",
    "flash_rel_attention_bwd_dkv": "bdm_db1_tpu/ops/pallas_attention.py:299",
}
K_SOURCES = {name: "bdm_db1_tpu_torch/csrc/flash_ring_decode.cu"
             for name in K_REPLACES}
K_SOURCES["quant_matmul"] = "bdm_db1_tpu_torch/csrc/quant_matmul.cu"
K_SOURCES["flash_rel_attention"] = \
    "bdm_db1_tpu_torch/csrc/flash_rel_attention.cu"
for _name in ("flash_rel_attention_bwd_dq", "flash_rel_attention_bwd_dkv"):
    K_SOURCES[_name] = "bdm_db1_tpu_torch/csrc/flash_rel_attention_bwd.cu"
# Kernel route (use_kernels True) against the plain ring branch (False) on
# the card. Per layer, on identical inputs, the attention output before
# o_net: max |diff| / max |attn|. The routes differ only by bf16 roundings
# (the query cast, p cast per key split against the full softmax), a few
# 2^-9 of a value; 2e-2 leaves room for that and none for a wrong mask,
# scale, rotation or merge, which move attention outputs by O(1) of their
# size. The int8 cache holds the same int8 values and scales on both
# routes, so the same limit holds there. The same limit holds K3 against
# rel_attention in the validation forward: p cast per key tile against the
# full softmax, and both outputs rounded to bf16. The gates stay within one
# layer: end to end, 24 layers grow any rounding difference (see the
# bf16-against-f32 readings beside them).
ATTN_REL_TOL = 2e-2
# The last layer run both ways from one input, then the tied head: max
# |diff| / max |logit|. One layer's rounding difference passes o_net, two
# LayerNorms, the FF and the head once (not 24 layers); a wrong route in
# that layer moves the logits by O(1) of their size.
LOGIT_REL_TOL = 5e-2


class _Recorder:
    """Keeps every action-token block a decoder returns (device tensors,
    read after the run) and passes everything else through."""

    def __init__(self, inner):
        self.inner = inner
        self.acts = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def decode_async(self, *args, **kwargs):
        act, mems = self.inner.decode_async(*args, **kwargs)
        self.acts.append(act)
        return act, mems


class _RecordingPool:
    def __init__(self, pool):
        self.pool = pool
        self.decoders = {}

    def get(self, tenv):
        dec = self.pool.get(tenv)
        return self.decoders.setdefault(id(dec), _Recorder(dec))


def _serve_setup(n_envs, episode_len, seed, **model_overrides):
    from bdm_db1_tpu_torch.core.config import db1_1p2b
    from bdm_db1_tpu_torch.data.rl_dataset import (
        RLFullDataset, RLTokenizerSuite, TrajectoryStore,
    )
    from bdm_db1_tpu_torch.eval.envs import FakeContinuousEnv
    from bdm_db1_tpu_torch.eval.wrapper import TokenizedEnv
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
    from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer

    cfg = db1_1p2b(**model_overrides)
    cfg.model.param_dtype = "bfloat16"   # served weights in bf16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = TransformerXL(cfg.model, cfg.vocab, device="cuda", generator=gen)
    layout = cfg.vocab.layout()
    suite = RLTokenizerSuite(layout,
                             ScalarTokenizer(cfg.vocab.num_continuous_bin))

    def env_fn(s):
        return FakeContinuousEnv(obs_dim=17, act_dim=6,
                                 episode_len=episode_len, seed=s)

    store = TrajectoryStore.from_flat_dataset(env_fn(999).make_dataset(3))
    ds = RLFullDataset("halfcheetah-geometry", store, suite,
                       seq_length=cfg.model.n_position, seed=0)

    def make_tenv(name):
        return TokenizedEnv(env_fn(int(name.split("-")[-1])), ds)

    names = [f"halfcheetah-{i}" for i in range(n_envs)]
    return cfg, model, layout, names, make_tenv


def _counters():
    from bdm_db1_tpu_torch.ops import flash_rel_attention as fra
    from bdm_db1_tpu_torch.ops import flash_ring_decode as fro
    from bdm_db1_tpu_torch.ops import quant_matmul as qm

    return fro.LAUNCHES, qm.LAUNCHES, fra.LAUNCHES


def _reset_launches():
    from bdm_db1_tpu_torch.ops import quant_matmul as qm

    for counts in _counters():
        for name in counts:
            counts[name] = 0
    qm.ROW_LAUNCHES.clear()


def _read_launches() -> dict:
    return {k: v for counts in _counters() for k, v in counts.items()}


def phase_serve(smi: str, *, phase: str, batch: int, steps: int = 8,
                seed: int = 0, **model_overrides) -> dict:
    from bdm_db1_tpu_torch.eval.decode import DecoderPool
    from bdm_db1_tpu_torch.eval.harness import evaluate_envs_lockstep
    from bdm_db1_tpu_torch.ops import flash_ring_decode as fro
    from bdm_db1_tpu_torch.ops import quant_matmul as qm

    cfg, model, layout, names, make_tenv = _serve_setup(
        batch, steps, seed, **model_overrides)
    int8_cache = cfg.model.decode_cache_dtype == "int8"
    int8_weights = cfg.model.decode_weight_dtype == "int8"
    L, A = cfg.model.n_layer, 6
    run = dict(num_trials=1, seed=100, batch_size=batch, interleave=1,
               strict_length=True)
    pool = _RecordingPool(DecoderPool(model))
    # warm-up: allocator, cuBLAS handles, the positional projections (and,
    # with int8 weights, the one-off weight quantization)
    evaluate_envs_lockstep(model, names, make_tenv, decoder_pool=pool,
                           max_step_size=2, **run)
    torch.cuda.synchronize()
    for rec in pool.decoders.values():
        rec.acts.clear()
    if int8_weights and not model.decode_weights_quantized():
        raise AssertionError("int8 decode weights were not quantized")

    # ---- the main path, counted --------------------------------------
    _reset_launches()
    t0 = time.perf_counter()
    res = evaluate_envs_lockstep(model, names, make_tenv, decoder_pool=pool,
                                 max_step_size=steps, **run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    qmm_rows = dict(sorted(qm.ROW_LAUNCHES.items()))
    # ------------------------------------------------------------------

    # the chunk plan: step 0 primes [prompt || obs || sep] in ring slices
    # (at 1.2B: 256-token slices on the plain ring branch, the last, 26
    # tokens, on the prime kernel); every later step primes [deferred
    # action || obs || sep], 19 tokens; each step then runs A - 1
    # single-token forwards. Every forward runs L layers, each with 4 trunk
    # matrices.
    dec = pool.get(make_tenv(names[0])).inner
    prompt, _ = make_tenv(names[0]).get_prompt(
        strict_length=True, rng=np.random.RandomState(0))
    q0 = len(prompt) + dec.obs_length + 1
    slices = dec.chunk_sizes(q0, 0) or [q0]
    forwards = len(slices) + steps * (A - 1) + (steps - 1)
    suffix = "_int8" if int8_cache else ""
    want = dict.fromkeys(launches, 0)
    want["flash_ring_decode" + suffix] = L * (
        steps * (A - 1) + slices.count(1))
    want["flash_ring_prime_ap" + suffix] = L * (
        steps - 1 + sum(2 <= q <= fro.MAX_PRIME_Q for q in slices))
    if int8_weights:
        want["quant_matmul"] = 4 * L * forwards
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    # K9 by row count: each forward's rows are its tokens x the batch (the
    # prompt slices, the 19-token steady primes, the single-token forwards)
    rows_want = {}
    if int8_weights:
        for rows, n in ([(q * batch, 1) for q in slices]
                        + [((dec.obs_length + 2) * batch, steps - 1),
                           (batch, steps * (A - 1))]):
            rows_want[rows] = rows_want.get(rows, 0) + 4 * L * n
        rows_want = dict(sorted(rows_want.items()))
    if (qmm_rows != rows_want
            or sum(qmm_rows.values()) != want["quant_matmul"]):
        raise AssertionError(f"K9 launches by rows {qmm_rows}, expected "
                             f"{rows_want} (sum {want['quant_matmul']})")
    if not all(r["length_mean"] == steps and r["num_trials"] == 1
               and np.isfinite(r["return_mean"]) for r in res):
        raise AssertionError(f"episode records off: {res[:3]}")
    acts = torch.cat([a for rec in pool.decoders.values()
                      for a in rec.acts]).cpu().numpy()
    if acts.shape != (steps * batch, A) or not (
            (acts >= layout.continuous_offset)
            & (acts < layout.separator_id)).all():
        raise AssertionError(f"action tokens off: shape {acts.shape}, "
                             f"range {acts.min()}..{acts.max()}")

    steady = _steady_steps(model, pool, make_tenv, names, layout, A)
    routes = _route_check(model, layout, batch, make_tenv, names,
                          f32_copy=not (int8_cache or int8_weights))
    return {"phase": phase, "config": "db1_1p2b", "dtype": "bfloat16",
            "decode_cache_dtype": cfg.model.decode_cache_dtype,
            "decode_weight_dtype": cfg.model.decode_weight_dtype,
            "batch": batch, "env_steps": steps, "card": smi,
            "prime_slices": slices, "forwards": forwards,
            "launches": launches, "launches_expected": want,
            "qmm_launches_by_rows": qmm_rows,
            "wall_s": wall, "actions_per_sec": batch * steps / wall,
            **steady, "kernel_vs_plain": routes}


def _steady_steps(model, pool, make_tenv, names, layout, A,
                  n: int = 10) -> dict:
    """Steady-state env steps driven directly (prime [deferred || obs ||
    sep]), each ended by a device sync. The rate is all n steps' actions
    over their summed wall time. The idle share is one profiled step's
    summed kernel time against the median unprofiled step (the profiler
    slows the host, so the profiled step's own wall time is not used)."""
    tenvs = [make_tenv(nm) for nm in names]
    dec = pool.get(tenvs[0]).inner
    B = len(tenvs)
    rng = np.random.RandomState(5)
    sep = np.full((B, 1), layout.separator_id, np.int64)
    start = np.stack([np.concatenate([t.get_prompt(rng=rng)[0],
                                      t.reset()[0], sep[0]]) for t in tenvs])
    act, mems = dec.decode(start, dec.init_mems(B), defer_last=True)

    def step(act, mems):
        obs, _ = tenvs[0].encode_obs_batch(
            [np.asarray(t.env.step(a)[0]) for t, a in zip(
                tenvs, tenvs[0].tok.decode_action_batch(act, False))])
        return dec.decode(np.concatenate([obs, sep], 1), mems,
                          deferred_tok=act[:, -1], defer_last=True)

    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        act, mems = step(act, mems)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    busy, top, prof_wall = _profile_busy(lambda: step(act, mems))
    step_s = float(np.median(times))
    return {"steady_actions_per_sec": n * B / sum(times),
            "steady_step_ms_median": step_s * 1e3,
            "steady_step_ms": [t * 1e3 for t in times],
            "profiled_step_ms": prof_wall * 1e3,
            "device_busy_ms": busy * 1e3,
            "device_idle_share": 1.0 - busy / step_s,
            "top_device_ms": top}


def _profile_busy(fn):
    """One profiled call of fn ending in a device sync: (summed device time
    s, the largest kernels by name in ms, the call's wall time s)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels only: a user annotation (the optimizer's step range) spans
    # kernels on the device timeline and would count them twice
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    # names without the namespace noise, long enough that the template
    # instantiations of one kernel stay apart
    return busy, {e.key.replace("(anonymous namespace)::", "")[:100]:
                  e.self_device_time_total / 1e3 for e in top}, wall


@torch.no_grad()
def _route_check(model, layout, B, make_tenv, names, f32_copy=True) -> dict:
    """One observation prime and one single-token forward from the same
    primed cache, driven layer by layer. Each layer's attention output with
    use_kernels True (the kernels) is held against use_kernels False (the
    plain ring branch) on the same input, and so are the logits after the
    last layer run both ways from its one input. Beside those gates, with
    ``f32_copy`` (a bf16 cache and weights), an f32 copy of the model reads
    how far bf16 alone moves each layer's output from the same bf16 input
    ("local"), the running hidden state ("propagated") and the
    last-position logits."""
    from bdm_db1_tpu_torch.eval.decode import build_decoder_for_env
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL

    tenvs = [make_tenv(nm) for nm in names[:B]]
    dec = build_decoder_for_env(model, tenvs[0])
    rng = np.random.RandomState(9)
    sep = np.full((B, 1), layout.separator_id, np.int64)
    start = np.stack([np.concatenate([t.get_prompt(rng=rng)[0],
                                      t.reset()[0], sep[0]]) for t in tenvs])
    act, cache = dec.decode(start, dec.init_mems(B), defer_last=True)
    obs = np.stack([t.reset()[0] for t in tenvs])
    prime = torch.as_tensor(np.concatenate([act[:, -1:], obs, sep], axis=1),
                            device="cuda")
    pos = torch.as_tensor(np.broadcast_to(
        np.r_[0, 1:obs.shape[1] + 2], prime.shape).copy(), device="cuda")
    one = torch.full((B, 1), layout.continuous_offset + 3, device="cuda")
    zero = torch.zeros((B, 1), dtype=torch.int64, device="cuda")

    m32 = cache32 = None
    if f32_copy:
        m32 = TransformerXL(dataclasses.replace(model.cfg, dtype="float32"),
                            model.vocab, device="cuda")
        m32.load_state_dict(model.state_dict())
        cache32 = {"k": cache["k"].float(), "v": cache["v"].float(),
                   "cursor": cache["cursor"]}

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    out = {"attn_tol": ATTN_REL_TOL, "logit_tol": LOGIT_REL_TOL}
    for name, tok, tpos in (("prime", prime, pos), ("q1", one, zero)):
        q = tok.shape[1]
        mask, mask_s = model.ring_masks(q, cache["cursor"], "cuda")
        rk = model.precompute_rk(q)
        h = model.embed_rl(tok, tpos)
        if f32_copy:
            rk32, h32 = m32.precompute_rk(q), m32.embed_rl(tok, tpos)
        attn_err, local, prop = [], [], []
        for li, layer in enumerate(model.h):
            ring = (rk[li], cache, li, mask, mask_s)
            attn = layer.dec_attn.attend_ring(h, *ring, True)[0]
            attn_p = layer.dec_attn.attend_ring(h, *ring, False)[0]
            attn_err.append(rel(attn, attn_p))
            h_in = h
            h = layer.forward_ring(h, *ring, True)[0]
            if f32_copy:
                layer32 = m32.h[li]
                ring32 = (rk32[li], cache32, li, mask, mask_s, False)
                local.append(rel(h, layer32.forward_ring(h_in.float(),
                                                         *ring32)[0]))
                h32 = layer32.forward_ring(h32, *ring32)[0]
                prop.append(rel(h, h32))
        logits = model.logits(h[:, -1])
        # the last layer both ways from the same input, through the head
        h_p = layer.forward_ring(h_in, *ring, False)[0]
        logits_p = model.logits(h_p[:, -1])
        out[name] = {"attn_rel_err_max": max(attn_err),
                     "last_layer_logits_rel_err": rel(logits, logits_p)}
        if f32_copy:
            out[name].update({
                "bf16_vs_f32_local_max": max(local),
                "bf16_vs_f32_propagated": prop,
                "logits_bf16_vs_f32": rel(logits, m32.logits(h32[:, -1]))})
        if not (torch.isfinite(logits).all()
                and out[name]["attn_rel_err_max"] <= ATTN_REL_TOL
                and out[name]["last_layer_logits_rel_err"] <= LOGIT_REL_TOL):
            raise AssertionError(f"kernel route vs plain ring branch: {out}")
    return out


# The validation loss of one micro-batch through the K3 route against the
# rel_attention route (attention_impl "xla"), same bf16 weights and data:
# |difference| at most EVAL_LOSS_TOL. Both routes round at other places
# (p per key tile, the bf16 PV product) and 24 layers carry that on. The
# readings that set it, on an H100: 1.8e-3 between the routes at a loss of
# 10.81, while the per-layer attention gap was at most 5.1e-3 of its
# largest value. With random weights the loss is near log V whatever the
# attention does, so this is a coarse end-to-end check; the per-layer
# ATTN_REL_TOL gate holds the route.
EVAL_LOSS_TOL = 1e-2
EVAL_MICRO = 4          # the JAX TrainConfig.micro_batch_size
EVAL_BATCHES = 8


def _eval_setup(seed: int):
    """db1_1p2b in bf16 (random weights from ``seed``) and its validation
    micro-batches: packed samples (prompts on) of a seeded HalfCheetah-
    geometry fake dataset (17 obs + separator + 6 action tokens a step, 43
    transitions per 1025-token sample), the valid split of the default
    "90,5,5", in sampler order. Each loader batch is [accum 1, micro 4]."""
    from bdm_db1_tpu_torch.core.config import db1_1p2b
    from bdm_db1_tpu_torch.data.rl_dataset import (
        RLFullDataset, RLTokenizerSuite, TrajectoryStore, split_rl_dataset,
    )
    from bdm_db1_tpu_torch.data.samplers import (
        SequentialSampler, collate_modalities,
    )
    from bdm_db1_tpu_torch.eval.envs import FakeContinuousEnv
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
    from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer

    cfg = db1_1p2b()
    cfg.model.param_dtype = "bfloat16"
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = TransformerXL(cfg.model, cfg.vocab, device="cuda", generator=gen)
    store = TrajectoryStore.from_flat_dataset(FakeContinuousEnv(
        obs_dim=17, act_dim=6, episode_len=200, seed=999).make_dataset(20))
    suite = RLTokenizerSuite(cfg.vocab.layout(),
                             ScalarTokenizer(cfg.vocab.num_continuous_bin))
    full = RLFullDataset("halfcheetah-geometry", store, suite,
                         seq_length=cfg.data.seq_length, seed=seed)
    _, valid, _ = split_rl_dataset(full, cfg.data.split)
    sampler = iter(SequentialSampler(len(valid), 0, EVAL_MICRO, 0, 1))
    batches = []
    for _ in range(EVAL_BATCHES + 1):   # the first one warms up
        raw = collate_modalities([valid[i] for i in next(sampler)], ["rl"])
        batches.append({m: {k: v[None] for k, v in f.items()}
                        for m, f in raw.items()})
    return cfg, model, full, batches


def phase_eval_loss(smi: str, seed: int = 0) -> dict:
    from bdm_db1_tpu_torch.train.trainer import evaluate_loss

    cfg, model, full, batches = _eval_setup(seed)
    L = cfg.model.n_layer
    seq = cfg.data.seq_length
    warm, batches = batches[0], batches[1:]
    evaluate_loss(model, [warm], device="cuda")
    torch.cuda.synchronize()

    # ---- the main path, counted --------------------------------------
    _reset_launches()
    losses, times = [], []
    for raw in batches:
        t0 = time.perf_counter()
        losses.append(evaluate_loss(model, [raw], device="cuda"))  # host read
        times.append(time.perf_counter() - t0)
    launches = _read_launches()
    # ------------------------------------------------------------------

    forwards = EVAL_BATCHES           # accum 1 per loader batch
    want = dict.fromkeys(launches, 0)
    want["flash_rel_attention"] = L * forwards
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    loss = float(np.mean(losses))
    log_v = float(np.log(full.tok.layout.total_vocab_size))
    # random tied weights give logits of O(1): near-uniform, ~log V
    if not (np.isfinite(losses).all() and 0.5 * log_v < loss < 2 * log_v):
        raise AssertionError(f"validation losses off: {losses}")
    tokens = EVAL_MICRO * seq
    step = float(np.median(times))
    busy, top, _ = _profile_busy(lambda: evaluate_loss(model, [batches[0]],
                                                       device="cuda"))
    routes = _eval_route_check(model, batches[0])
    return {"phase": "eval_loss", "config": "db1_1p2b", "dtype": "bfloat16",
            "micro_batch": EVAL_MICRO, "seq_length": seq,
            "micro_batches": EVAL_BATCHES, "forwards": forwards,
            "valid_samples": len(batches) * EVAL_MICRO, "card": smi,
            "launches": launches, "launches_expected": want,
            "loss": loss, "losses": losses, "log_vocab": log_v,
            "tokens_per_sec": tokens * EVAL_BATCHES / sum(times),
            "micro_batch_ms_median": step * 1e3,
            "micro_batch_ms": [t * 1e3 for t in times],
            "device_busy_ms": busy * 1e3,
            "device_idle_share": 1.0 - busy / step,
            "top_device_ms": top, "kernel_vs_plain": routes}


@torch.no_grad()
def _eval_route_check(model, raw) -> dict:
    """One micro-batch driven layer by layer: each layer's attention output
    through K3 against ``rel_attention`` on the same input (limit
    ATTN_REL_TOL of its largest value); then the loss through each route
    end to end (limit EVAL_LOSS_TOL)."""
    from bdm_db1_tpu_torch.models.transformer_xl import use_rel_kernel
    from bdm_db1_tpu_torch.ops.attention import same_length_mask
    from bdm_db1_tpu_torch.ops.positional import relative_positional_embedding
    from bdm_db1_tpu_torch.train.trainer import evaluate_loss, to_gato_batch

    cfg = model.cfg
    rl = to_gato_batch({m: {k: v[0] for k, v in f.items()}
                        for m, f in raw.items()}, device="cuda")["rl"]
    qlen = rl.tokens.shape[1]
    if not use_rel_kernel(cfg, qlen, qlen, "cuda"):
        raise AssertionError("the validation forward does not take K3")
    mask = same_length_mask(qlen, qlen, cfg.mem_len, device="cuda")
    r = relative_positional_embedding(qlen, cfg.n_embed,
                                      cfg.effective_clamp_len, device="cuda")
    h = model.embed_rl(rl.tokens, rl.position_id)
    errs = []
    for layer in model.h:
        attn = layer.dec_attn.attend(h, r, None, mask, True)
        attn_p = layer.dec_attn.attend(h, r, None, mask, False)
        errs.append(float((attn.float() - attn_p.float()).abs().max()
                          / attn_p.float().abs().max()))
        h = layer(h, None, r, mask, True)
    loss_k = evaluate_loss(model, [raw], device="cuda")
    impl = cfg.attention_impl
    cfg.attention_impl = "xla"       # the rel_attention route
    try:
        loss_p = evaluate_loss(model, [raw], device="cuda")
    finally:
        cfg.attention_impl = impl
    out = {"attn_tol": ATTN_REL_TOL, "attn_rel_err": errs,
           "attn_rel_err_max": max(errs), "loss_kernel": loss_k,
           "loss_plain": loss_p, "loss_abs_diff": abs(loss_k - loss_p),
           "loss_tol": EVAL_LOSS_TOL}
    if not (max(errs) <= ATTN_REL_TOL and np.isfinite(loss_p)
            and abs(loss_k - loss_p) <= EVAL_LOSS_TOL):
        raise AssertionError(f"K3 route vs rel_attention: {out}")
    return out


# The training gradients through the K3-K5 route against autograd through
# rel_attention. Per layer, on the same bf16 inputs (rel_attention in f32
# over them) and the same seeded upstream gradient, each of the six
# gradients: max |diff| at most GRAD_REL_TOL of its largest value. K4/K5
# round p and dS to bf16 for the tensor-core products and dq, dk, dv to
# bf16 on output, so each gradient carries a few 2^-9 of its size; a wrong
# mask, shift or scale moves a gradient by O(1) of its size. Readings on an
# H100 80GB HBM3 (700 W), worst layer of 24, two runs (the loader's threads
# may hand the check another micro-batch): dq 1.6e-2 / 1.4e-2, dk 6.7e-3 /
# 5.8e-3, dv 3.7e-3 / 3.7e-3, drk 9.7e-3 / 7.4e-3, drw 1.8e-2 / 2.2e-2, drr
# 2.3e-2 / 2.1e-2.
GRAD_REL_TOL = 5e-2
# The whole model's gradient on one micro-batch through both routes with
# the same dropout masks: the global norms within GRAD_NORM_RTOL of each
# other and a cosine similarity of at least GRAD_COS_MIN. Both routes round
# at other places (bf16 p, dS and outputs in the kernels) and 24 layers
# carry that on, so this is a coarse end-to-end check; the per-layer
# GRAD_REL_TOL gate holds the route. Readings on an H100 80GB HBM3 (700 W),
# two runs: norms 7.1e-3 and 8.8e-3 apart, cosines 0.9921 and 0.9908.
GRAD_NORM_RTOL = 3e-2
GRAD_COS_MIN = 0.98
TRAIN_MICRO = 4         # the JAX TrainConfig.micro_batch_size
TRAIN_ACCUM = 2
TRAIN_STEPS = 8


def _train_setup(seed: int):
    """db1_1p2b with bf16 activations and f32 parameters (random weights
    from ``seed``), the ModelConfig dropout rates (flax dropout) and the
    OptimizerConfig defaults; its train split of the eval phase's dataset
    wired as ``pretrain.build_loader`` wires it: RandomSampler(seed =
    TrainConfig.seed), mixture counts {"rl": 4} and StratifiedGatoLoader
    with accum 2."""
    from bdm_db1_tpu_torch.core.config import db1_1p2b
    from bdm_db1_tpu_torch.data.rl_dataset import (
        RLFullDataset, RLTokenizerSuite, TrajectoryStore, split_rl_dataset,
    )
    from bdm_db1_tpu_torch.data.samplers import (
        RandomSampler, StratifiedGatoLoader, mixture_counts,
    )
    from bdm_db1_tpu_torch.eval.envs import FakeContinuousEnv
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
    from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer

    cfg = db1_1p2b()
    assert (cfg.model.dtype, cfg.model.param_dtype) == ("bfloat16",
                                                        "float32")
    cfg.train = dataclasses.replace(
        cfg.train, micro_batch_size=TRAIN_MICRO,
        global_batch_size=TRAIN_MICRO * TRAIN_ACCUM, log_interval=1,
        eval_interval=1 << 30)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = TransformerXL(cfg.model, cfg.vocab, device="cuda", generator=gen)
    store = TrajectoryStore.from_flat_dataset(FakeContinuousEnv(
        obs_dim=17, act_dim=6, episode_len=200, seed=999).make_dataset(20))
    suite = RLTokenizerSuite(cfg.vocab.layout(),
                             ScalarTokenizer(cfg.vocab.num_continuous_bin))
    full = RLFullDataset("halfcheetah-geometry", store, suite,
                         seq_length=cfg.data.seq_length, seed=seed)
    train = split_rl_dataset(full, cfg.data.split)[0]
    counts = mixture_counts({"rl": 1.0}, cfg.train.micro_batch_size)
    accum = cfg.train.global_batch_size // cfg.train.micro_batch_size
    sampler = RandomSampler(len(train), 0, counts["rl"], 0, 1,
                            seed=cfg.train.seed)
    loader = StratifiedGatoLoader({"rl": train}, {"rl": sampler}, counts,
                                  accum, num_threads=cfg.data.num_workers)
    return cfg, model, full, loader


def phase_train(smi: str, seed: int = 0) -> dict:
    from bdm_db1_tpu_torch.train.step import init_train_state, make_train_step
    from bdm_db1_tpu_torch.train.trainer import Trainer, to_gato_batch

    cfg, model, full, loader = _train_setup(seed)
    L = cfg.model.n_layer
    try:
        raw = next(loader)
        routes = _train_route_check(model, raw)
        torch.cuda.empty_cache()
        state = init_train_state(model, cfg.train.optimizer,
                                 cfg.train.train_iters)
        step = make_train_step(model)
        marks, losses = [], []

        def timed_step(st, batch, gen):
            marks.append(time.perf_counter())
            st, met = step(st, batch, gen)
            losses.append(met["loss"])
            return st, met

        def run(n, st):
            tcfg = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, train_iters=n))
            trainer = Trainer(tcfg, model, timed_step, st, loader)
            trainer.train()
            return trainer.state

        state = run(1, state)                   # warm-up
        torch.cuda.synchronize()
        before = [p.detach().clone() for p in model.parameters()]
        marks.clear()
        losses.clear()
        torch.cuda.reset_peak_memory_stats()

        # ---- the main path, counted ----------------------------------
        _reset_launches()
        state = run(TRAIN_STEPS, state)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        launches = _read_launches()
        # --------------------------------------------------------------

        peak = torch.cuda.max_memory_allocated()
        micro = TRAIN_STEPS * TRAIN_ACCUM
        want = dict.fromkeys(launches, 0)
        for name in ("flash_rel_attention", "flash_rel_attention_bwd_dq",
                     "flash_rel_attention_bwd_dkv"):
            want[name] = L * micro
        if launches != want:
            raise AssertionError(f"kernel launches {launches}, expected "
                                 f"{want}")
        losses = [float(x) for x in losses]
        log_v = float(np.log(full.tok.layout.total_vocab_size))
        if not (np.isfinite(losses).all()
                and 0.5 * log_v < losses[0] < 2 * log_v
                and losses[-1] < losses[0]):
            raise AssertionError(f"training losses off: {losses}")
        changed = [not torch.equal(a, p) for a, p in
                   zip(before, model.parameters())]
        finite = all(bool(torch.isfinite(p).all())
                     for p in model.parameters())
        del before
        if not (finite and all(changed)):
            raise AssertionError(f"parameters finite: {finite}, changed: "
                                 f"{sum(changed)} of {len(changed)}")
        times = np.diff(marks)
        tokens = TRAIN_ACCUM * TRAIN_MICRO * cfg.data.seq_length
        step_s = float(np.median(times))
        batch = to_gato_batch(next(loader), "cuda")
        gen = torch.Generator(device="cuda").manual_seed(1)
        busy, top, _ = _profile_busy(lambda: step(state, batch, gen))
    finally:
        loader.stop()
    return {"phase": "train", "config": "db1_1p2b", "dtype": "bfloat16",
            "param_dtype": "float32", "micro_batch": TRAIN_MICRO,
            "accum": TRAIN_ACCUM, "seq_length": cfg.data.seq_length,
            "steps": TRAIN_STEPS, "card": smi, "optimizer": dataclasses.asdict(
                cfg.train.optimizer),
            "dropout": {"drop": cfg.model.drop,
                        "embd_pdrop": cfg.model.embd_pdrop,
                        "dropattn": cfg.model.dropattn,
                        "impl": cfg.model.dropout_impl},
            "launches": launches, "launches_expected": want,
            "losses": losses, "log_vocab": log_v,
            "tokens_per_sec": tokens * TRAIN_STEPS / float(times.sum()),
            "step_ms_median": step_s * 1e3,
            "step_ms": [t * 1e3 for t in times],
            "device_busy_ms": busy * 1e3,
            "device_idle_share": 1.0 - busy / step_s,
            "max_memory_allocated_gb": peak / 1e9,
            "top_device_ms": top, "gradient_routes": routes}


def _train_route_check(model, raw) -> dict:
    """One micro-batch of a loader batch. Layer by layer (under no_grad
    between layers): the six attention gradients through K3-K5 against
    autograd through ``rel_attention`` in f32 on the same inputs and one
    seeded upstream gradient (GRAD_REL_TOL). Then the whole model's
    gradient through both routes (attention_impl "auto" and "xla") from one
    generator seed, so that the dropout masks are equal: global norms
    within GRAD_NORM_RTOL, cosine similarity at least GRAD_COS_MIN."""
    from bdm_db1_tpu_torch.models.transformer_xl import use_rel_kernel
    from bdm_db1_tpu_torch.ops import flash_rel_attention as fra
    from bdm_db1_tpu_torch.ops.attention import rel_attention, same_length_mask
    from bdm_db1_tpu_torch.ops.positional import relative_positional_embedding
    from bdm_db1_tpu_torch.train.trainer import to_gato_batch

    cfg = model.cfg
    batch = to_gato_batch({m: {k: v[0] for k, v in f.items()}
                           for m, f in raw.items()}, device="cuda")
    rl = batch["rl"]
    qlen = rl.tokens.shape[1]
    if not use_rel_kernel(cfg, qlen, qlen, "cuda"):
        raise AssertionError("the training forward does not take K3-K5")
    H, Dh, D = cfg.n_head, cfg.d_head, cfg.n_embed
    mask = same_length_mask(qlen, qlen, cfg.mem_len, device="cuda")
    r = relative_positional_embedding(qlen, D, cfg.effective_clamp_len,
                                      device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    kw = dict(mem_len=cfg.mem_len, same_length=cfg.same_length,
              scale=1.0 / Dh ** 0.5)
    worst = dict.fromkeys(GRAD_NAMES, 0.0)
    with torch.no_grad():
        h = model.embed_rl(rl.tokens, rl.position_id)
    for layer in model.h:
        a = layer.dec_attn
        with torch.no_grad():
            q, k, v = F.linear(h, a.qkv_net.weight.to(h.dtype)).split(D, -1)
            q, k, v = (t.unflatten(-1, (H, Dh)) for t in (q, k, v))
            rk = F.linear(r.to(h.dtype), a.r_net.weight.to(h.dtype)).view(
                qlen, H, Dh)
        ins = [t.detach().requires_grad_(True) for t in
               (q, k, v, rk, a.r_w_bias.float(), a.r_r_bias.float())]
        g = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
        got = torch.autograd.grad(fra.flash_rel_attention(*ins, **kw), ins,
                                  g)
        ref_ins = [t.detach().float().requires_grad_(True) for t in ins]
        ref = torch.autograd.grad(
            rel_attention(*ref_ins, mask, scale=kw["scale"],
                          compute_dtype=torch.float32), ref_ins, g.float())
        for name, x, y in zip(GRAD_NAMES, got, ref):
            worst[name] = max(worst[name], float(
                (x.float() - y).abs().max() / y.abs().max()))
        del got, ref, ref_ins, ins
        with torch.no_grad():
            h = layer(h, None, r, mask, True)

    params = list(model.parameters())
    flat = {}
    impl = cfg.attention_impl
    try:
        for route, name in (("auto", "kernel"), ("xla", "plain")):
            cfg.attention_impl = route
            _, loss = model(batch, compute_loss=True, deterministic=False,
                            loss_only=True,
                            generator=torch.Generator(
                                device="cuda").manual_seed(4))
            flat[name] = [gr.float() for gr in
                          torch.autograd.grad(loss, params)]
            del loss
    finally:
        cfg.attention_impl = impl
    dot = sum(float((x.double() * y.double()).sum())
              for x, y in zip(flat["kernel"], flat["plain"]))
    nk = sum(float(x.double().square().sum()) for x in flat["kernel"]) ** 0.5
    npl = sum(float(y.double().square().sum()) for y in flat["plain"]) ** 0.5
    del flat
    out = {"grad_tol": GRAD_REL_TOL, "attn_grad_rel_err": worst,
           "grad_norm_kernel": nk, "grad_norm_plain": npl,
           "grad_norm_rel_diff": abs(nk - npl) / npl,
           "grad_norm_rtol": GRAD_NORM_RTOL, "grad_cosine": dot / (nk * npl),
           "grad_cosine_min": GRAD_COS_MIN}
    if not (all(v <= GRAD_REL_TOL for v in worst.values())
            and out["grad_norm_rel_diff"] <= GRAD_NORM_RTOL
            and out["grad_cosine"] >= GRAD_COS_MIN):
        raise AssertionError(f"K3-K5 gradients vs rel_attention: {out}")
    return out


def kernels_line(kernels: dict, launches: dict) -> dict:
    """One record per kernel: its numbers at the main path's shape (the
    first case of each; K9 at the serve's q == 1 rows and the largest trunk
    matrix, with every timed K9 shape under ``cases``) and its launches in
    the counted main-path runs of the same process. K8 is held by the
    kernels phase only: no main path runs it."""
    cases = kernels["cases"]
    pick = {name: cases[name][0] for name in cases}
    pick["quant_matmul"] = next(
        c for c in cases["quant_matmul"]
        if c["shape"] == {"R": QMM_ROWS[0], "K": 2048, "N": 8192})
    k7 = cases["flash_ring_prime_ap_int8"][0]
    pick["flash_ring_prime"] = dict(k7, ms=k7["k8_ms"],
                                    max_abs_err=k7["k8_max_abs_err"])
    # K4 and K5 share one record: each its time and bound, the plain
    # backward's time (both kernels' work) and the SDPA backward (K4 + K5)
    # (with --old-rel-bwd, the old K5's time in turns as dkv_old_ms)
    bwd = cases["flash_rel_attention_bwd"][0]
    for which, grads in (("dq", ("dq",)),
                         ("dkv", ("dk", "dv", "drk", "drw", "drr"))):
        pick["flash_rel_attention_bwd_" + which] = dict(
            bwd, **bwd[which], max_abs_err=max(bwd["abs_err"][n]
                                               for n in grads))
    rows = []
    for name, replaces in K_REPLACES.items():
        case = pick[name]
        rows.append({
            "name": name, "route": "cuda", "source": K_SOURCES[name],
            "replaces": replaces, "launches": launches[name],
            "on_path": launches[name] > 0,
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"],
            "shape": case["shape"]})
        if name.startswith("flash_rel_attention_bwd") \
                and "old_ms" in case["dkv"]:
            rows[-1]["dkv_old_ms"] = case["dkv"]["old_ms"]
        if name == "quant_matmul":
            rows[-1]["cases"] = [
                {k: c[k] for k in ("shape", "ms", "bound_ms", "bound_by",
                                   "library_ms", "plain_ms", "old_ms")
                 if k in c}
                for c in cases[name] if "ms" in c]
    return {"kernels": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--old-qmm", default=None, metavar="SRC",
                    help="a copy of an earlier csrc/quant_matmul.cu: its K9 is "
                         "timed in turns with this tree's")
    ap.add_argument("--old-rel-bwd", default=None, metavar="SRC",
                    help="a copy of an earlier csrc/flash_rel_attention_bwd.cu:"
                         " its K5 is timed in turns with this tree's")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    results = {}
    if "build" in phases:
        results["build"] = phase_build()
        emit(results["build"])
    if "kernels" in phases:
        results["kernels"] = phase_kernels(args.old_qmm, args.old_rel_bwd)
        emit(results["kernels"])
    serves = {"serve": dict(batch=40),
              "serve_int8": dict(batch=56, decode_cache_dtype="int8",
                                 decode_weight_dtype="int8")}
    for phase, kw in serves.items():
        if phase in phases:
            gc.collect()
            torch.cuda.empty_cache()
            results[phase] = phase_serve(smi, phase=phase, **kw)
            emit(results[phase])
    for phase, fn in (("eval_loss", phase_eval_loss), ("train", phase_train)):
        if phase in phases:
            gc.collect()
            torch.cuda.empty_cache()
            results[phase] = fn(smi)
            emit(results[phase])

    print(smi, flush=True)
    # launches are counted only on the main paths (both serves, the
    # validation loss and training): without them this run has no count
    if "kernels" in results and all(p in results for p in MAIN_PATHS):
        launches = {name: sum(results[p]["launches"][name]
                              for p in MAIN_PATHS)
                    for name in K_REPLACES}
        emit(kernels_line(results["kernels"], launches))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
