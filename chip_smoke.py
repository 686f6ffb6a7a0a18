"""GPU smoke run of the PyTorch/CUDA port (bdm_db1_tpu_torch) on one card.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --phases build,kernels

Phases, each printing one JSON line:

* ``build``   — nvcc builds every CUDA source of the port's main path
  (one nvcc per source, all started together).
* ``kernels`` — each kernel against its plain PyTorch version at the
  db1_1p2b serving shapes (B = 40, M = 1024, H = 16, Dh = 128; Q = 19 and
  26 for the prime kernel; a layer index other than 0) and at one small
  ragged shape, with its time, its bound, the plain version's time and one
  PyTorch library call's time as a yardstick.
* ``serve``   — db1_1p2b in bf16 with random weights from a seed serves 40
  lockstep HalfCheetah-geometry envs (17 obs tokens, 6 continuous actions)
  with strict-length expert prompts through the port's
  ``evaluate_envs_lockstep``; checks the kernels' launch counts against the
  chunk plan, the action tokens' range, and, layer by layer, the kernel
  route against the plain ring branch on one prime and one single-token
  forward; reads how far bf16 moves each layer from an f32 copy.

Then it prints the card's name and power limit (nvidia-smi), one JSON line
with every kernel's numbers and its launches on the main path (only when
``kernels`` and ``serve`` both ran, as with no arguments), and as the last
line
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is then
not 0 and no result line is printed. It needs one CUDA card and imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12        # dense bf16 tensor-core peak
PHASES = ("build", "kernels", "serve")
# Kernel against its plain version, normalised output: max |diff| at most
# OUT_REL_TOL * max |plain output|. Both round p to bf16 per split before
# the PV product with the same split maxima, so they differ only where an
# exp lands on the other side of a bf16 rounding: a few 2^-9 of one key's
# weight, about 2e-4 of the largest output. A split whose PV is dropped or
# misweighted moves outputs by a share of their size, far above the limit.
OUT_REL_TOL = 2e-3


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time per call of fn(i) over ``iters`` calls (CUDA
    events); i lets a caller rotate through layers so no launch finds the
    previous one's bytes in L2."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_build() -> dict:
    from bdm_db1_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    built = cuda_build.build_libraries(["flash_ring_decode"])
    rec = {"phase": "build", "seconds": time.perf_counter() - t0,
           "sources": {k: v["seconds"] for k, v in built.items()}}
    for name, info in built.items():
        # ptxas resource lines (registers, shared memory, spills)
        print(f"[nvcc {name}]\n{info['log'].strip()}", file=sys.stderr)
    return rec


def _kernel_case(fro, *, L, B, M, H, Dh, Q, layer, seed, timed):
    """One kernel (K1 when Q is None, else K2) against its plain version on
    the same inputs. Returns the comparison and, when timed, the times."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    scale = 1.0 / Dh ** 0.5
    k = torch.randn(L, B, M, H, Dh, device=dev, generator=gen).to(torch.bfloat16)
    v = torch.randn(L, B, M, H, Dh, device=dev, generator=gen).to(torch.bfloat16)
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
        kern, plain = fro.flash_ring_prime, fro.flash_ring_prime_plain

    o, m, l = kern(k, v, qw, bias, layer, scale=scale)
    torch.cuda.synchronize()
    o_p, m_p, l_p = plain(k, v, qw, bias, layer, scale=scale, block_m=split)
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
                     "layer": layer},
           "max_abs_err": err, "out_plain_absmax": out_max,
           "m_abs_err": m_err, "l_rel_err": l_rel, "tol": tol, "ok": bool(ok)}
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {rec}")
    if timed:
        cache_bytes = 2 * B * M * H * Dh * 2
        io_bytes = (qw.numel() * 2 + bias.numel() * 4
                    + B * H * nq * Dh * 4 + 2 * B * H * nq * 4)
        flops = 2 * 2 * B * H * nq * M * Dh
        rec["bytes"] = cache_bytes + io_bytes
        rec["flops"] = flops
        t_bytes = rec["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        rec["bound_ms"] = max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        rec["ms"] = time_ms(lambda i: kern(
            k, v, qw, bias, i % L, scale=scale), iters=48)
        rec["plain_ms"] = time_ms(lambda i: plain(
            k, v, qw, bias, i % L, scale=scale, block_m=split), iters=6,
            warmup=1)
        # yardstick only: one PyTorch call computing the normalised output
        # of the same attention (the port never calls it)
        qs = (qw if Q is not None else qw[:, :, None])
        mask = bias if Q is not None else bias[:, :, None]

        def lib(i):
            kl = k[i % L].permute(0, 2, 1, 3)
            vl = v[i % L].permute(0, 2, 1, 3)
            return F.scaled_dot_product_attention(
                qs, kl, vl, attn_mask=mask.to(torch.bfloat16), scale=scale)

        rec["library_ms"] = time_ms(lib, iters=12, warmup=2)
    return rec


def phase_kernels() -> dict:
    from bdm_db1_tpu_torch.ops import flash_ring_decode as fro

    full = dict(L=24, B=40, M=1024, H=16, Dh=128, layer=17)
    ragged = dict(L=3, B=3, M=200, H=4, Dh=128, layer=2)
    cases = {
        "flash_ring_decode": [
            _kernel_case(fro, Q=None, seed=1, timed=True, **full),
            _kernel_case(fro, Q=None, seed=2, timed=False, **ragged)],
        "flash_ring_prime": [
            _kernel_case(fro, Q=19, seed=3, timed=True, **full),
            _kernel_case(fro, Q=26, seed=4, timed=True, **full),
            _kernel_case(fro, Q=5, seed=5, timed=False, **ragged)],
    }
    return {"phase": "kernels", "cases": cases}


K1_REPLACES = "bdm_db1_tpu/ops/flash_ring_decode.py:249"
K2_REPLACES = "bdm_db1_tpu/ops/flash_ring_decode.py:578"
SOURCE = "bdm_db1_tpu_torch/csrc/flash_ring_decode.cu"
# Kernel route (use_kernels True) against the plain ring branch (False) on
# the card. Per layer, on identical inputs, the attention output before
# o_net: max |diff| / max |attn|. The routes differ only by bf16 roundings
# (the query cast, p cast per key split against the full softmax), a few
# 2^-9 of a value; 2e-2 leaves room for that and none for a wrong mask,
# scale, rotation or merge, which move attention outputs by O(1) of their
# size. The gates stay within one layer: end to end, 24 layers grow any
# rounding difference (see the bf16-against-f32 readings beside them).
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


def _serve_setup(n_envs, episode_len, seed):
    from bdm_db1_tpu_torch.core.config import db1_1p2b
    from bdm_db1_tpu_torch.data.rl_dataset import (
        RLFullDataset, RLTokenizerSuite, TrajectoryStore,
    )
    from bdm_db1_tpu_torch.eval.envs import FakeContinuousEnv
    from bdm_db1_tpu_torch.eval.wrapper import TokenizedEnv
    from bdm_db1_tpu_torch.models.transformer_xl import TransformerXL
    from bdm_db1_tpu_torch.tokenizers.scalar import ScalarTokenizer

    cfg = db1_1p2b()
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


def phase_serve(smi: str, steps: int = 8, batch: int = 40,
                seed: int = 0) -> dict:
    from bdm_db1_tpu_torch.eval.decode import DecoderPool
    from bdm_db1_tpu_torch.eval.harness import evaluate_envs_lockstep
    from bdm_db1_tpu_torch.ops import flash_ring_decode as fro

    cfg, model, layout, names, make_tenv = _serve_setup(batch, steps, seed)
    L, A = cfg.model.n_layer, 6
    run = dict(num_trials=1, seed=100, batch_size=batch, interleave=1,
               strict_length=True)
    pool = _RecordingPool(DecoderPool(model))
    # warm-up: allocator, cuBLAS handles, the positional projections
    evaluate_envs_lockstep(model, names, make_tenv, decoder_pool=pool,
                           max_step_size=2, **run)
    torch.cuda.synchronize()
    for rec in pool.decoders.values():
        rec.acts.clear()

    # ---- the main path, counted --------------------------------------
    fro.flash_ring_decode.launches = 0
    fro.flash_ring_prime.launches = 0
    t0 = time.perf_counter()
    res = evaluate_envs_lockstep(model, names, make_tenv, decoder_pool=pool,
                                 max_step_size=steps, **run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_ring_decode": fro.flash_ring_decode.launches,
                "flash_ring_prime": fro.flash_ring_prime.launches}
    # ------------------------------------------------------------------

    # per env step: one observation prime (the last prompt slice at step
    # 0, 26 tokens; [deferred action || obs || sep], 19 tokens, after)
    # and A - 1 single-token forwards, each over L layers
    want = {"flash_ring_decode": steps * L * (A - 1),
            "flash_ring_prime": steps * L}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
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
    routes = _route_check(model, layout, batch, make_tenv, names)
    return {"phase": "serve", "config": "db1_1p2b", "dtype": "bfloat16",
            "batch": batch, "env_steps": steps, "card": smi,
            "launches": launches, "launches_expected": want,
            "wall_s": wall, "actions_per_sec": batch * steps / wall,
            **steady, "kernel_vs_plain": routes}


def _steady_steps(model, pool, make_tenv, names, layout, A,
                  n: int = 10) -> dict:
    """Steady-state env steps driven directly (prime [deferred || obs ||
    sep]), each ended by a device sync. The rate is all n steps' actions
    over their summed wall time. The idle share is one profiled step's
    summed kernel time against the median unprofiled step (the profiler
    slows the host, so the profiled step's own wall time is not used)."""
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        act, mems = step(act, mems)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    step = float(np.median(times))
    return {"steady_actions_per_sec": n * B / sum(times),
            "steady_step_ms_median": step * 1e3,
            "steady_step_ms": [t * 1e3 for t in times],
            "profiled_step_ms": prof_wall * 1e3,
            "device_busy_ms": busy * 1e3,
            "device_idle_share": 1.0 - busy / step,
            "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3
                              for e in top}}


@torch.no_grad()
def _route_check(model, layout, B, make_tenv, names) -> dict:
    """One observation prime and one single-token forward from the same
    primed cache, driven layer by layer. Each layer's attention output with
    use_kernels True (the kernels) is held against use_kernels False (the
    plain ring branch) on the same input, and so are the logits after the
    last layer run both ways from its one input. Beside those gates, an
    f32 copy of the model reads how far bf16 alone moves each layer's
    output from the same bf16 input ("local"), the running hidden state
    ("propagated") and the last-position logits."""
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

    m32 = TransformerXL(dataclasses.replace(model.cfg, dtype="float32"),
                        model.vocab, device="cuda")
    m32.load_state_dict(model.state_dict())
    k, v, cursor = cache["k"], cache["v"], cache["cursor"]
    k32, v32 = k.float(), v.float()

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    out = {"attn_tol": ATTN_REL_TOL, "logit_tol": LOGIT_REL_TOL}
    for name, tok, tpos in (("prime", prime, pos), ("q1", one, zero)):
        q = tok.shape[1]
        mask, mask_s = model.ring_masks(q, cursor, "cuda")
        rk, rk32 = model.precompute_rk(q), m32.precompute_rk(q)
        h, h32 = model.embed_rl(tok, tpos), m32.embed_rl(tok, tpos)
        attn_err, local, prop = [], [], []
        for li, (layer, layer32) in enumerate(zip(model.h, m32.h)):
            ring = (rk[li], k, v, li, cursor, mask, mask_s)
            ring32 = (rk32[li], k32, v32, li, cursor, mask, mask_s, False)
            attn = layer.dec_attn.attend_ring(h, *ring, True)[0]
            attn_p = layer.dec_attn.attend_ring(h, *ring, False)[0]
            attn_err.append(rel(attn, attn_p))
            h_in = h
            h = layer.forward_ring(h, *ring, True)[0]
            h_f = layer32.forward_ring(h_in.float(), *ring32)[0]
            local.append(rel(h, h_f))
            h32 = layer32.forward_ring(h32, *ring32)[0]
            prop.append(rel(h, h32))
        logits = model.logits(h[:, -1])
        # the last layer both ways from the same input, through the head
        h_p = layer.forward_ring(h_in, *ring, False)[0]
        logits_p = model.logits(h_p[:, -1])
        out[name] = {"attn_rel_err_max": max(attn_err),
                     "last_layer_logits_rel_err": rel(logits, logits_p),
                     "bf16_vs_f32_local_max": max(local),
                     "bf16_vs_f32_propagated": prop,
                     "logits_bf16_vs_f32": rel(logits,
                                               m32.logits(h32[:, -1]))}
        if not (torch.isfinite(logits).all()
                and out[name]["attn_rel_err_max"] <= ATTN_REL_TOL
                and out[name]["last_layer_logits_rel_err"] <= LOGIT_REL_TOL):
            raise AssertionError(f"kernel route vs plain ring branch: {out}")
    return out


def kernels_line(kernels: dict, launches: dict) -> dict:
    """One record per kernel: its numbers at the main path's shape and its
    launches in the counted main-path run of the same process."""
    rows = []
    for name, replaces in (("flash_ring_decode", K1_REPLACES),
                           ("flash_ring_prime", K2_REPLACES)):
        case = kernels["cases"][name][0]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"],
            "shape": case["shape"]})
    return {"kernels": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
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
        results["kernels"] = phase_kernels()
        emit(results["kernels"])
    if "serve" in phases:
        results["serve"] = phase_serve(smi)
        emit(results["serve"])

    print(smi, flush=True)
    # launches are counted only on the main path (serve): without it this
    # run has no count to print
    if "kernels" in results and "serve" in results:
        emit(kernels_line(results["kernels"], results["serve"]["launches"]))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
