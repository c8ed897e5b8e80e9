"""On-card check of the PyTorch port's serving path: ``python3 chip_smoke.py``.

Needs one CUDA device (an H100: the kernels are built for sm_90a) and exits
non-zero without one.  From the repository root it:

1. builds ``commu_tpu_torch/csrc/*.cu`` with nvcc (first use) and holds every
   kernel against its plain PyTorch twin on the card, at the serving path's
   shapes, with the stated tolerance; times both with CUDA events;
2. checks the full-width model's prefill and decode logits on the card
   against the same model on the CPU (plain versions);
3. writes seeded random weights at ``ModelConfig()`` full width to a
   reference-format ``.pt`` and runs the serving loop of
   ``python -m commu_tpu_torch.generate --serve --lenient`` in-process, with
   requests of width 1 and 8, at generation length 1024 and at the default
   (cache capacity 4096), in float32 and bfloat16; every answer must be ok,
   every .mid it lists must parse back, and every kernel must have launched;
4. prints one JSON line of per-kernel results, the card's name and power
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
}


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
        missing = [k for k, n in resp["kernel_launches"].items() if n <= 0]
        if missing:
            raise AssertionError(f"{resp['request_id']}: kernels {missing} "
                                 "never launched")
        rate = resp["tokens"] / (resp["wall_ms"] / 1e3)
        print(f"[serve] {resp['request_id']}: ok files={len(resp['files'])} "
              f"wall_ms={resp['wall_ms']:.1f} tokens={resp['tokens']} "
              f"generated tokens/s={rate:.1f} [{card}]")
    missing = [k for k, n in launches.items() if n <= 0]
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

    kernels = check_kernels(card)
    with tempfile.TemporaryDirectory() as tmp:
        pt_path = Path(tmp) / "model.pt"
        write_weights(pt_path)
        check_model(pt_path, card)
        launches = serve(pt_path, Path(tmp) / "out", card)

    if any(m.split(".")[0] in ("jax", "flax") for m in sys.modules):
        raise AssertionError("JAX was imported")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
         "replaces": KERNEL_INFO[name][1], "launches": launches[name],
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "shape": shape}
        for name, (err, ms, plain_ms, shape) in kernels.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
