"""On-card check of the PyTorch port's serving and evaluation paths:
``python3 chip_smoke.py``.

Needs one CUDA device (an H100: the kernels are built for sm_90a) and exits
non-zero without one.  From the repository root it:

1. builds ``commu_tpu_torch/csrc/*.cu`` with nvcc (first use; one nvcc per
   source, all started together) and holds every kernel against its plain
   PyTorch twin on the card, at the serving path's shapes and at the eval
   shape (B = 10, T = 128, M = 2048 at ``ModelConfig()`` width), in float32
   and bfloat16, with the stated tolerance; times both with CUDA events;
2. checks the full-width model's prefill and decode logits on the card
   against the same model on the CPU (plain versions);
3. writes seeded random weights at ``ModelConfig()`` full width to a
   reference-format ``.pt`` and runs the serving loop of
   ``python -m commu_tpu_torch.generate --serve --lenient`` in-process, with
   requests of width 1 and 8, at generation length 1024 and at the default
   (cache capacity 4096), in float32 and bfloat16; every answer must be ok,
   every .mid it lists must parse back, and every serving kernel must have
   launched;
4. runs a short full-width eval (batch 2, tgt 128, mem 256, a ring that
   wraps) with ``Trainer.evaluate`` on the card and on the CPU (plain
   versions) and holds the NLL sums and token counts against each other;
5. runs ``Trainer.evaluate("valid")`` at ``ModelConfig()`` and
   ``EvaluateConfig()`` (batch 10, tgt 128, mem 2048) over a seeded
   synthetic val split, in float32 and bfloat16: the NLL must be finite and
   every eval kernel must have launched;
6. prints one JSON line of per-kernel results, the card's name and power
   limit, and ``{"ok": true, "device": {...}}`` as the last line.

Any failure raises, so the exit code is non-zero and no result line prints.
"""
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

F32_TOL = 1e-4   # f32: kernel and plain sum in different orders
BF16_TOL = 2e-2  # bf16: a one-ulp rounding flip is ~4e-3 relative
MODEL_TOL = 1e-3  # six f32 layers, card vs CPU
KERNEL_INFO = {
    "rel_attention_fwd": ("commu_tpu_torch/csrc/rel_attention_fwd.cu",
                          "commu_tpu/ops/fused_attention.py:698"),
    "ffn_block_fwd": ("commu_tpu_torch/csrc/ffn_block_fwd.cu",
                      "commu_tpu/ops/fused_ffn.py:120"),
    "cache_append": ("commu_tpu_torch/csrc/cache_append.cu",
                     "commu_tpu/ops/layout.py:126"),
    "project_mem_kv": ("commu_tpu_torch/csrc/project_mem_kv.cu",
                       "commu_tpu/ops/fused_attention.py:1539"),
    "rel_attention_mem_fwd": ("commu_tpu_torch/csrc/rel_attention_mem_fwd.cu",
                              "commu_tpu/ops/fused_attention.py:698"),
    "ring_write_layer": ("commu_tpu_torch/csrc/ring_write_layer.cu",
                         "commu_tpu/ops/layout.py:70"),
    "nll_fwd": ("commu_tpu_torch/csrc/nll_fwd.cu",
                "commu_tpu/ops/fused_nll.py:58"),
}
SERVE_KERNELS = ("rel_attention_fwd", "ffn_block_fwd", "cache_append")
EVAL_KERNELS = ("project_mem_kv", "rel_attention_mem_fwd", "ring_write_layer",
                "nll_fwd", "ffn_block_fwd")


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _cuda_ms(fn, iters=50, warmup=5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _compare(name, ours, ref, tol) -> float:
    import torch

    torch.cuda.synchronize()
    err = (ours.float() - ref.float()).abs()
    bound = tol + tol * ref.float().abs()
    if not torch.isfinite(ours.float()).all() or bool((err > bound).any()):
        raise AssertionError(f"{name}: max abs err {err.max().item():.3e} "
                             f"exceeds atol=rtol={tol}")
    return err.max().item()


def check_kernels(card: str) -> dict:
    """Phase 1: every kernel against its plain twin at the path's shapes."""
    import torch

    from commu_tpu_torch.ops import fused_attention as fa
    from commu_tpu_torch.ops import fused_ffn, layout

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    d_model, heads, d_ff = 500, 10, 1000
    dh = d_model // heads
    scale = 1.0 / dh ** 0.5
    results = {}

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for g in (1, 8):
            for t in (11, 128):
                q, k, v = (randn(g, heads, dh, t, dtype=dtype) for _ in range(3))
                w_r = fa.pack_r_kernel(randn(d_model, d_model, std=0.05),
                                       heads).to(dtype)
                rwbs, rrbs = fa._scaled_biases(randn(heads, dh, std=0.1),
                                               randn(heads, dh, std=0.1),
                                               scale, dtype)
                trig_a = fa.query_trig_table(t, 0, d_model, dtype, dev)
                psi = fa.key_trig_basis(t, d_model, dtype, dev)
                mask = fa.build_mask_bias(t, 0, 0, 0, False, device=dev)
                reset = (torch.arange(g, device=dev) % 3 == 1).int()
                args = (q, rwbs, rrbs, k, v, w_r, trig_a, psi, mask, reset,
                        scale)
                err = _compare(f"rel_attention_fwd G={g} T={t} {dtype}",
                               fa.rel_attention_fwd(*args),
                               fa.rel_attention_fwd_plain(*args), tol)
                ms = _cuda_ms(lambda: fa.rel_attention_fwd(*args))
                plain_ms = _cuda_ms(lambda: fa.rel_attention_fwd_plain(*args))
                print(f"[kernel] rel_attention_fwd G={g} T={t} {dtype}: "
                      f"max_abs_err={err:.3e} (atol=rtol={tol}) "
                      f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms [{card}]")
                if (g, t, dtype) == (8, 11, torch.float32):
                    results["rel_attention_fwd"] = (err, ms, plain_ms,
                                                    "G=8 T=11 float32")

        g, t = 8, 11
        x, o = randn(g, d_model, t, dtype=dtype), randn(g, d_model, t, dtype=dtype)
        w1 = randn(d_model, d_ff, std=0.05, dtype=dtype)
        w2 = randn(d_ff, d_model, std=0.05, dtype=dtype)
        b1 = randn(d_ff, std=0.1)
        b2, be1, be2 = (randn(d_model, std=0.1) for _ in range(3))
        g1, g2 = (1.0 + randn(d_model, std=0.1) for _ in range(2))
        args = (x, o, w1, b1, w2, b2, g1, be1, g2, be2)
        err = _compare(f"ffn_block_fwd G={g} T={t} {dtype}",
                       fused_ffn.ffn_block_fwd(*args),
                       fused_ffn.ffn_block_fwd_plain(*args), tol)
        ms = _cuda_ms(lambda: fused_ffn.ffn_block_fwd(*args))
        plain_ms = _cuda_ms(lambda: fused_ffn.ffn_block_fwd_plain(*args))
        print(f"[kernel] ffn_block_fwd G={g} T={t} {dtype}: "
              f"max_abs_err={err:.3e} (atol=rtol={tol}) "
              f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms [{card}]")
        if dtype == torch.float32:
            results["ffn_block_fwd"] = (err, ms, plain_ms, "G=8 T=11 float32")

        n_layers, g = 6, 8
        for m_cap in (1152, 4096):
            k, v = (randn(n_layers, g, heads, dh, m_cap, dtype=dtype)
                    for _ in range(2))
            k_self, v_self = (randn(n_layers, g, heads, dh, dtype=dtype)
                              for _ in range(2))
            length = torch.tensor([0, 127, 128, 500, m_cap - 1, m_cap,
                                   m_cap - 1, 3], dtype=torch.int32, device=dev)
            advance = torch.tensor([1, 1, 0, 1, 1, 1, 0, 1], dtype=torch.bool,
                                   device=dev)
            kk, vk, kp, vp = k.clone(), v.clone(), k.clone(), v.clone()
            layout.cache_append(kk, vk, k_self, v_self, length, advance)
            layout.cache_append_plain(kp, vp, k_self, v_self, length, advance)
            torch.cuda.synchronize()
            if not (torch.equal(kk, kp) and torch.equal(vk, vp)):
                raise AssertionError(f"cache_append M={m_cap} {dtype}: "
                                     "kernel and plain differ")
            if torch.equal(kk, k):
                raise AssertionError("cache_append wrote nothing")
            err = (kk.float() - kp.float()).abs().max().item()
            ms = _cuda_ms(lambda: layout.cache_append(
                kk, vk, k_self, v_self, length, advance))
            plain_ms = _cuda_ms(lambda: layout.cache_append_plain(
                kp, vp, k_self, v_self, length, advance))
            print(f"[kernel] cache_append L={n_layers} G={g} M={m_cap} {dtype}: "
                  f"max_abs_err={err:.3e} (exact) kernel={ms:.4f} ms "
                  f"plain={plain_ms:.4f} ms [{card}]")
            if (m_cap, dtype) == (4096, torch.float32):
                results["cache_append"] = (err, ms, plain_ms,
                                           "L=6 G=8 M=4096 float32")
    return results


def check_eval_kernels(card: str) -> dict:
    """Phase 1b: the eval path's kernels against their plain twins at the
    eval shape: ModelConfig() width, B = 10, T = 128, a ring of R = 16 slabs
    of 128 (M = 2048), L + 1 = 7 streams, vocabulary 729."""
    import torch

    from commu_tpu_torch.ops import fused_attention as fa
    from commu_tpu_torch.ops import fused_ffn, fused_nll, layout

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    d_model, heads, d_ff, vocab = 500, 10, 1000, 729
    dh = d_model // heads
    b, t, r_blocks, streams = 10, 128, 16, 7
    m_cap = r_blocks * t
    scale = 1.0 / dh ** 0.5
    results = {}

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def report(name, shape, dtype, err, tol, ms, plain_ms):
        print(f"[kernel] {name} {shape} {dtype}: max_abs_err={err:.3e} "
              f"({tol}) kernel={ms:.4f} ms plain={plain_ms:.4f} ms [{card}]")
        if dtype == torch.float32:
            results[name] = (err, ms, plain_ms, f"{shape} float32")

    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        tol_s = f"atol=rtol={tol}"
        mem = randn(streams, r_blocks, b, d_model, t, dtype=dtype)
        wk, wv = (randn(d_model, heads, dh, std=0.05) for _ in range(2))
        k_mem, v_mem = fa.project_mem_kv(mem, 3, wk, wv)
        wk2, wv2 = (w.reshape(d_model, -1).to(dtype) for w in (wk, wv))
        kp, vp = fa.project_mem_kv_plain(mem, 3, wk2, wv2)
        err = max(_compare(f"project_mem_kv {dtype}", k_mem.reshape(kp.shape),
                           kp, tol),
                  _compare(f"project_mem_kv {dtype}", v_mem.reshape(vp.shape),
                           vp, tol))
        report("project_mem_kv", "L+1=7 layer=3 B=10 R=16 Tb=128", dtype, err,
               tol_s, _cuda_ms(lambda: fa.project_mem_kv(mem, 3, wk, wv)),
               _cuda_ms(lambda: fa.project_mem_kv_plain(mem, 3, wk2, wv2)))

        q, k_win, v_win = (randn(b, heads, dh, t, dtype=dtype)
                           for _ in range(3))
        w_r = fa.pack_r_kernel(randn(d_model, d_model, std=0.05),
                               heads).to(dtype)
        rwbs, rrbs = fa._scaled_biases(randn(heads, dh, std=0.1),
                                       randn(heads, dh, std=0.1), scale, dtype)
        trig_a = fa.query_trig_table(t, m_cap, d_model, dtype, dev)
        reset = (torch.arange(b, device=dev) == 3).int()
        for count, head in ((0, 0), (1024, 1024), (m_cap, 640)):
            psi = fa.ring_psi(fa.key_trig_basis(m_cap + t, d_model, dtype, dev),
                              t, count, head)
            mask = fa.build_mask_bias(t, m_cap, count, head, True, device=dev)
            args = (q, rwbs, rrbs, k_mem, k_win, v_mem, v_win, w_r, trig_a,
                    psi, mask, reset, scale)
            shape = f"B=10 T=128 M=2048 count={count} head={head}"
            err = _compare(f"rel_attention_mem_fwd {shape} {dtype}",
                           fa.rel_attention_mem_fwd(*args),
                           fa.rel_attention_mem_fwd_plain(*args), tol)
            if count == m_cap:
                report("rel_attention_mem_fwd", shape, dtype, err, tol_s,
                       _cuda_ms(lambda: fa.rel_attention_mem_fwd(*args), 20),
                       _cuda_ms(lambda: fa.rel_attention_mem_fwd_plain(*args),
                                20))
            else:
                print(f"[kernel] rel_attention_mem_fwd {shape} {dtype}: "
                      f"max_abs_err={err:.3e} ({tol_s}) [{card}]")

        rows = randn(b, d_model, t, dtype=dtype)
        buf_k, buf_p = mem.clone(), mem.clone()
        layout.ring_write_layer(buf_k, rows, 5, 11)
        layout.ring_write_layer_plain(buf_p, rows, 5, 11)
        torch.cuda.synchronize()
        if not torch.equal(buf_k, buf_p) or torch.equal(buf_k, mem):
            raise AssertionError(f"ring_write_layer {dtype}: kernel and "
                                 "plain differ, or nothing was written")
        report("ring_write_layer", "L+1=7 R=16 B=10 D=500 Tb=128", dtype, 0.0,
               "exact", _cuda_ms(lambda: layout.ring_write_layer(
                   buf_k, rows, 5, 11)),
               _cuda_ms(lambda: layout.ring_write_layer_plain(
                   buf_p, rows, 5, 11)))

        hidden = randn(b, d_model, t, dtype=dtype)
        emb, bias = randn(vocab, d_model, std=0.05), randn(vocab, std=0.1)
        targets = torch.randint(1, vocab, (b, t), generator=gen, device=dev,
                                dtype=torch.int32)
        targets[:, 100:] = 0  # PAD: scored like any other, masked later
        err = _compare(f"nll_fwd {dtype}",
                       fused_nll.nll_fwd(hidden, emb, bias, targets),
                       fused_nll.nll_fwd_plain(hidden, emb, bias, targets),
                       F32_TOL)
        report("nll_fwd", "B=10 D=500 T=128 V=729", dtype, err,
               f"atol=rtol={F32_TOL}, f32 logits",
               _cuda_ms(lambda: fused_nll.nll_fwd(hidden, emb, bias, targets)),
               _cuda_ms(lambda: fused_nll.nll_fwd_plain(hidden, emb, bias,
                                                        targets)))

        x, o = rows, randn(b, d_model, t, dtype=dtype)
        w1 = randn(d_model, d_ff, std=0.05, dtype=dtype)
        w2 = randn(d_ff, d_model, std=0.05, dtype=dtype)
        b1 = randn(d_ff, std=0.1)
        b2, be1, be2 = (randn(d_model, std=0.1) for _ in range(3))
        g1, g2 = (1.0 + randn(d_model, std=0.1) for _ in range(2))
        args = (x, o, w1, b1, w2, b2, g1, be1, g2, be2)
        err = _compare(f"ffn_block_fwd G=10 T=128 {dtype}",
                       fused_ffn.ffn_block_fwd(*args),
                       fused_ffn.ffn_block_fwd_plain(*args), tol)
        ms = _cuda_ms(lambda: fused_ffn.ffn_block_fwd(*args))
        plain_ms = _cuda_ms(lambda: fused_ffn.ffn_block_fwd_plain(*args))
        print(f"[kernel] ffn_block_fwd G=10 T=128 {dtype}: "
              f"max_abs_err={err:.3e} ({tol_s}) kernel={ms:.4f} ms "
              f"plain={plain_ms:.4f} ms [{card}]")
    return results


def write_corpus(data_dir: Path, lengths, seed: int) -> None:
    """A synthetic split in the reference's npy layout, made with numpy: 11
    meta tokens in [560, 729) and events in [2, 560) per sequence, so that a
    sequence (after the BOS the dataset prepends) has the given length.
    Writes the val split and a two-sequence train split (the dataset loads
    both)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    data_dir.mkdir(parents=True, exist_ok=True)

    def split(name, lens):
        metas = np.empty(len(lens), dtype=object)
        events = np.empty(len(lens), dtype=object)
        for i, n in enumerate(lens):
            metas[i] = rng.randint(560, 729, size=11).astype(np.int64)
            events[i] = rng.randint(2, 560, size=n - 12).astype(np.int64)
        np.save(data_dir / f"input_{name}.npy", metas, allow_pickle=True)
        np.save(data_dir / f"target_{name}.npy", events, allow_pickle=True)

    split("train", [300, 300])
    split("val", list(lengths))


def check_eval_model(data_dir: Path, card: str) -> None:
    """Phase 4: a short full-width eval (batch 2, tgt 128, mem 256: two
    slabs, so the ring wraps) on the card against the same eval on the CPU
    (plain versions), f32, from the same seeded weights."""
    import torch

    from commu_tpu_torch.training import EvaluateConfig, Trainer, TrainingConfig

    cfg = TrainingConfig(evaluate=EvaluateConfig(batch_size=2, tgt_length=128,
                                                 mem_length=256))
    totals = {}
    for dev in ("cuda", "cpu"):
        trainer = Trainer(str(data_dir), cfg, device=dev,
                          model_dtype=torch.float32)
        totals[dev] = trainer.evaluate("valid")
    (tok_c, nll_c), (tok_p, nll_p) = totals["cuda"], totals["cpu"]
    if tok_c != tok_p or abs(nll_c - nll_p) > MODEL_TOL * abs(nll_p):
        raise AssertionError(f"eval card vs CPU: tokens {tok_c} vs {tok_p}, "
                             f"nll_sum {nll_c} vs {nll_p} (rtol {MODEL_TOL})")
    print(f"[eval-model] ModelConfig() batch 2 tgt 128 mem 256, card vs CPU: "
          f"tokens={tok_c} nll_sum={nll_c:.6f} vs {nll_p:.6f} "
          f"rel_err={abs(nll_c - nll_p) / abs(nll_p):.3e} "
          f"(rtol={MODEL_TOL}) [{card}]")


def evaluate(data_dir: Path, card: str) -> dict:
    """Phase 5: Trainer.evaluate("valid") at ModelConfig() and
    EvaluateConfig(), in float32 and bfloat16; returns the launches per
    kernel summed over both runs."""
    import math

    import torch

    from commu_tpu_torch.ops import _build
    from commu_tpu_torch.training import Trainer

    launches = {name: 0 for name in _build.LAUNCHES}
    for dtype in (torch.float32, torch.bfloat16):
        trainer = Trainer(str(data_dir), device="cuda", model_dtype=dtype)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        tokens, nll_sum = trainer.evaluate("valid")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = dict(_build.LAUNCHES)
        nll = nll_sum / max(tokens, 1)
        if not math.isfinite(nll) or tokens <= 0:
            raise AssertionError(f"eval {dtype}: tokens {tokens}, nll {nll}")
        missing = [k for k in EVAL_KERNELS if run[k] <= 0]
        if missing:
            raise AssertionError(f"eval {dtype}: kernels {missing} never "
                                 "launched")
        windows = run["nll_fwd"]  # one per window
        print(f"[eval] ModelConfig() EvaluateConfig() {dtype}: tokens={tokens} "
              f"val_nll={nll:.6f} wall_s={wall:.3f} windows={windows} "
              f"ms_per_window={1e3 * wall / windows:.3f} "
              f"eval_tokens/s={tokens / wall:.1f} launches={run} [{card}]")
        for name, n in run.items():
            launches[name] += n
    return launches


def write_weights(path: Path) -> None:
    """Phase 2: seeded random weights at ModelConfig() in reference .pt
    layout (the JAX package's initializer)."""
    import torch

    from commu_tpu_torch.models import VOCAB_SIZE, ModelConfig, TransformerXL

    model = TransformerXL(VOCAB_SIZE, ModelConfig())
    model.init_parameters(torch.Generator().manual_seed(0))
    torch.save({"model": model.state_dict()}, str(path))


def check_model(pt_path: Path, card: str) -> None:
    """Phase 2b: full-width prefill + decode on the card (kernels) against
    the same model on the CPU (plain versions)."""
    import torch

    from commu_tpu_torch.generation.pipeline import load_model
    from commu_tpu_torch.models import VOCAB_SIZE, ModelConfig, decode

    cfg = ModelConfig(same_length=True)
    tokens = torch.randint(1, VOCAB_SIZE, (2, 14),
                           generator=torch.Generator().manual_seed(1))
    logits = {}
    for dev in ("cuda", "cpu"):
        model = load_model(str(pt_path), cfg, torch.device(dev))
        tok = tokens.to(dev)
        with torch.inference_mode():
            out = [model.logits(model(tok[:, :11]))]
            rel = decode.precompute_rel(model, cfg, 128)
            cache = decode.prefill(model, cfg, tok[:, :11],
                                   decode.init_cache(cfg, 2, 128, device=dev))
            adv = torch.ones(2, dtype=torch.bool, device=dev)
            for j in range(11, 14):
                step, k_self, v_self = decode.decode_step(model, cfg, rel,
                                                          tok[:, j], cache)
                cache = decode.commit(cache, k_self, v_self, adv)
                out.append(step)
        logits[dev] = [x.cpu() for x in out]
    err = 0.0
    for i, (a, b) in enumerate(zip(logits["cuda"], logits["cpu"])):
        err = max(err, _compare(f"model logits {i}", a, b, MODEL_TOL))
    print(f"[model] ModelConfig() prefill + 3 decode steps, card vs CPU: "
          f"max_abs_err={err:.3e} (atol=rtol={MODEL_TOL}) [{card}]")


def serve(pt_path: Path, out_dir: Path, card: str) -> dict:
    """Phase 3: the real serve loop, in-process, through three server runs
    (--gen_length and --decode_dtype are per process)."""
    from commu_tpu_torch import generate
    from commu_tpu_torch.generation.postprocess import read_midi
    from commu_tpu_torch.ops import _build

    meta = {"bpm": 70, "audio_key": "aminor", "time_signature": "4/4",
            "pitch_range": "mid", "inst": "acoustic_piano", "genre": "newage",
            "min_velocity": 60, "max_velocity": 80,
            "track_role": "main_melody", "rhythm": "standard"}
    four_bars = {"num_measures": 4.0, "chord_progression": "-".join(["C"] * 32)}
    eight_bars = {"num_measures": 8.0, "chord_progression": "-".join(
        (["Am"] * 8 + ["F"] * 8 + ["C"] * 8 + ["G"] * 8) * 2)}
    runs = [
        (["--gen_length", "1024"],
         [{"request_id": "w1-len1024-f32", "num_generate": 1, **four_bars},
          {"request_id": "w8-len1024-f32", "num_generate": 8, **eight_bars}]),
        ([],
         [{"request_id": "w8-len4096-f32", "num_generate": 8, **four_bars}]),
        (["--gen_length", "1024", "--decode_dtype", "bfloat16"],
         [{"request_id": "w8-len1024-bf16", "num_generate": 8, **eight_bars}]),
    ]
    _build.reset_launches()
    responses = []
    for flags, requests in runs:
        buf = io.StringIO()
        lines = "".join(json.dumps({**meta, **r, "seed": 1}) + "\n"
                        for r in requests)
        generate.main(["--checkpoint_dir", str(pt_path), "--output_dir",
                       str(out_dir), "--serve", "--lenient", "--device",
                       "cuda", *flags], stdin=io.StringIO(lines), stdout=buf)
        out = [json.loads(x) for x in buf.getvalue().splitlines()]
        if out[0].get("status") != "ready" or len(out) != len(requests) + 1:
            raise AssertionError(f"serve protocol: {out}")
        responses += out[1:]
    launches = dict(_build.LAUNCHES)

    for resp in responses:
        if not resp.get("ok"):
            raise AssertionError(f"request failed: {resp}")
        for path in resp["files"]:
            read_midi(path)
        missing = [k for k in SERVE_KERNELS if resp["kernel_launches"][k] <= 0]
        if missing:
            raise AssertionError(f"{resp['request_id']}: kernels {missing} "
                                 "never launched")
        rate = resp["tokens"] / (resp["wall_ms"] / 1e3)
        print(f"[serve] {resp['request_id']}: ok files={len(resp['files'])} "
              f"wall_ms={resp['wall_ms']:.1f} tokens={resp['tokens']} "
              f"generated tokens/s={rate:.1f} [{card}]")
    missing = [k for k in SERVE_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels {missing} never launched on the path")
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from commu_tpu_torch.ops import _build

    card = _card()
    print(f"[card] {card}")
    print(f"[versions] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    build = _build.build_seconds
    print(f"[build] nvcc sm_90a: "
          f"{'%.1f s' % build if build is not None else 'reused'} "
          f"(library ready after {time.perf_counter() - t0:.1f} s)")

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
        return out

    kernels = phase("serving kernels", check_kernels, card)
    kernels.update(phase("eval kernels", check_eval_kernels, card))
    with tempfile.TemporaryDirectory() as tmp:
        pt_path = Path(tmp) / "model.pt"
        write_weights(pt_path)
        phase("serving model", check_model, pt_path, card)
        serve_launches = phase("serve", serve, pt_path, Path(tmp) / "out",
                               card)
        write_corpus(Path(tmp) / "short", [700, 500, 650], seed=2)
        phase("eval model", check_eval_model, Path(tmp) / "short", card)
        lengths = [3000] + [200 + 140 * i for i in range(9)] + \
            [3000] + [2900 - 150 * i for i in range(9)]
        write_corpus(Path(tmp) / "val", lengths, seed=3)
        eval_launches = phase("eval", evaluate, Path(tmp) / "val", card)

    if any(m.split(".")[0] in ("jax", "flax") for m in sys.modules):
        raise AssertionError("JAX was imported")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
         "replaces": KERNEL_INFO[name][1],
         "launches": serve_launches[name] + eval_launches[name],
         "launches_serve": serve_launches[name],
         "launches_eval": eval_launches[name],
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "shape": shape}
        for name, (err, ms, plain_ms, shape) in kernels.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
