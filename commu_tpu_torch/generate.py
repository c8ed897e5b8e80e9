"""Metadata-conditioned MIDI generation on a CUDA device.

PyTorch counterpart of the root ``generate.py``: the same flags (the
reference's, plus --serve / --batch_json / --lenient / --gen_length /
--decode_dtype / --seed / --warm / --sampler), driving the batched device
sampler or, with ``--sampler host``, the reference-parity loop (single
requests and ``--serve``; ``--batch_json`` always runs the device sampler),
and ``--device`` (default ``cuda``; ``cpu`` only when asked for
explicitly).

    python -m commu_tpu_torch.generate --checkpoint_dir ./model.pt \\
        --output_dir ./out --bpm 70 --audio_key aminor --time_signature 4/4 \\
        --pitch_range mid --num_measures 8 --inst acoustic_piano \\
        --genre newage --min_velocity 60 --max_velocity 80 \\
        --track_role main_melody --rhythm standard --num_generate 3 \\
        --chord_progression "Am-Am-Am-Am-Am-Am-Am-Am-..."

Float32 matrix products run in full float32 (TF32 is switched off here):
float32 decode is the parity path.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ComMU generation (PyTorch/CUDA)")
    from .utils import constants

    p.add_argument("--checkpoint_dir", type=str, required=True,
                   help="reference-format .pt checkpoint")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--bpm", type=int)
    p.add_argument("--audio_key", type=str, choices=list(constants.KEY_MAP.keys()))
    p.add_argument("--time_signature", type=str,
                   choices=list(constants.TIME_SIG_MAP.keys()))
    p.add_argument("--pitch_range", type=str,
                   choices=list(constants.PITCH_RANGE_MAP.keys()))
    p.add_argument("--num_measures", type=float)
    p.add_argument("--inst", type=str, choices=list(constants.INST_MAP.keys()))
    p.add_argument("--genre", type=str, default="cinematic",
                   choices=list(constants.GENRE_MAP.keys()))
    p.add_argument("--track_role", type=str,
                   choices=list(constants.TRACK_ROLE_MAP.keys()))
    p.add_argument("--rhythm", type=str, default="standard",
                   choices=list(constants.RHYTHM_MAP.keys()))
    p.add_argument("--min_velocity", type=int, choices=range(1, 128))
    p.add_argument("--max_velocity", type=int, choices=range(1, 128))
    p.add_argument("--chord_progression", type=str, default=None,
                   help="Chord progression ex) C-C-E-E-G-G ... "
                        "(required unless --batch_json)")
    p.add_argument("--num_generate", type=int, default=1)
    p.add_argument("--top_k", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.95)
    p.add_argument("--sampler", choices=["jit", "host"], default="jit",
                   help="jit: the batched device sampler; host: the "
                        "reference-parity loop (one token per host step)")
    p.add_argument("--decode_dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="bfloat16: bf16 weights and KV cache (slightly "
                        "different logits; float32 is the parity path)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gen_length", type=int, default=None,
                   help="override max generation length (smoke runs)")
    p.add_argument("--lenient", action="store_true",
                   help="keep sequences even if they fail musical validation "
                        "(useful with untrained checkpoints)")
    p.add_argument("--batch_json", type=str, default=None,
                   help="JSON file with a LIST of request objects (same keys "
                        "as the CLI flags); all prompts are generated in ONE "
                        "batched device episode")
    p.add_argument("--warm", action="store_true",
                   help="with --serve: run one throwaway episode at the "
                        "default request shape before printing the ready "
                        "line (builds the kernels and, on CUDA, captures "
                        "that shape's decode graphs)")
    p.add_argument("--serve", action="store_true",
                   help="serving loop: read one JSON request object per "
                        "stdin line (same keys as the CLI flags, plus "
                        "optional request_id/seed), write one JSON response "
                        "line per request to stdout; the model stays "
                        "resident.  CLI meta flags are defaults for fields a "
                        "request omits.")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cpu runs the kernels' plain versions")
    return p.parse_args(argv)


META_KEYS = ("bpm", "audio_key", "time_signature", "pitch_range",
             "num_measures", "inst", "genre", "min_velocity", "max_velocity",
             "track_role", "rhythm")


def _serve(args, pipeline, stdin, stdout) -> None:
    from .generation import GenerationInput, postprocess
    from .ops import _build

    log = logging.getLogger("ComMU")
    defaults = {k: getattr(args, k) for k in META_KEYS
                if getattr(args, k) is not None}
    if args.chord_progression:
        defaults["chord_progression"] = args.chord_progression
    base_rec = {"output_dir": args.output_dir,
                "num_generate": args.num_generate,
                "top_k": args.top_k, "temperature": args.temperature}
    ready = {"status": "ready", "checkpoint": args.checkpoint_dir}
    if args.warm:
        t0 = time.perf_counter()
        pipeline.generate_sequences(
            GenerationInput.from_dict({**base_rec, **defaults}), seed=0,
            validate=False)
        ready["capture_s"] = pipeline.episode_totals()["capture_s"]
        log.info("serve warmup done in %.1fs (graph capture %.2fs)",
                 time.perf_counter() - t0, ready["capture_s"])
    print(json.dumps(ready), file=stdout, flush=True)
    counters: dict = {}  # per-output-stem file numbering (no overwrites)
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        req_id = None
        try:
            req = json.loads(line)
            req_id = req.pop("request_id", None)
            seed = int(req.pop("seed", args.seed))
            input_data = GenerationInput.from_dict(
                {**base_rec, **defaults, **req})
            before = dict(_build.LAUNCHES)
            totals = pipeline.episode_totals()
            t0 = time.perf_counter()
            sequences = pipeline.generate_sequences(
                input_data, seed=seed, validate=not args.lenient)
            wall = time.perf_counter() - t0
            files = []
            stem = (input_data.output_dir, input_data.track_role,
                    input_data.inst, input_data.pitch_range)
            base = counters.get(stem, 0)
            for idx, seq in enumerate(sequences):
                path = postprocess.output_file_path(input_data, base + idx)
                postprocess.decode_event_sequence(seq).dump(str(path))
                files.append(str(path))
            counters[stem] = base + len(sequences)
            after = pipeline.episode_totals()
            print(json.dumps({
                "request_id": req_id, "ok": True, "files": files,
                "wall_ms": wall * 1e3,
                # tokens generated past the 12-token primer + meta prefix
                "tokens": sum(len(s) - 12 for s in sequences),
                "kernel_launches": {k: _build.LAUNCHES[k] - before[k]
                                    for k in before},
                # the decode steps of its episodes (one graph replay each on
                # CUDA), and the warm-up steps and seconds of a capture
                # that the request made (its shape's first call)
                **{k: after[k] - totals[k] for k in after},
            }), file=stdout, flush=True)
        except Exception as exc:  # noqa: BLE001 - keep serving
            log.exception("request %s failed", req_id)
            print(json.dumps({"request_id": req_id, "ok": False,
                              "error": f"{type(exc).__name__}: {exc}"}),
                  file=stdout, flush=True)


def main(argv=None, stdin=None, stdout=None) -> None:
    """Entry point; ``stdin``/``stdout`` default to the process streams
    (``--serve`` reads requests from one and answers on the other)."""
    args = parse_args(argv)
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout

    import dataclasses

    import torch

    from .config import get_default_cfg_inference
    from .utils.logging import configure_logging

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu explicitly to run "
                         "the plain PyTorch versions of the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # --serve speaks line-JSON on stdout; logs ride stderr there
    configure_logging(None, stream=sys.stderr if args.serve else None)

    from .generation import GenerationInput, MidiGenerationPipeline, postprocess

    icfg = get_default_cfg_inference()
    if args.gen_length is not None:
        icfg = dataclasses.replace(icfg, generation_length=args.gen_length)
    pipeline = MidiGenerationPipeline(
        args.checkpoint_dir, inference_cfg=icfg, device=device,
        decode_dtype=torch.bfloat16 if args.decode_dtype == "bfloat16"
        else torch.float32, sampler=args.sampler)

    if args.serve:
        _serve(args, pipeline, stdin, stdout)
        return

    if args.batch_json:
        from .generation import device_sampler

        with open(args.batch_json) as fh:
            records = json.load(fh)
        inputs = [GenerationInput.from_dict({
            "output_dir": args.output_dir, "num_generate": 1,
            "top_k": args.top_k, "temperature": args.temperature, **rec,
        }) for rec in records]
        metas = [pipeline.encode_input_meta(i) for i in inputs]
        results = device_sampler.execute_batch(
            pipeline.model, pipeline.model_cfg, pipeline.inference_cfg,
            inputs, metas, seed=args.seed, validate=not args.lenient,
            episode_cache=pipeline.episode_cache)
        for idx, (inp, seq) in enumerate(zip(inputs, results)):
            path = postprocess.output_file_path(inp, idx)
            postprocess.decode_event_sequence(seq).dump(str(path))
        print(f"Generated {len(results)} files under: {args.output_dir}",
              file=stdout)
        return

    if not args.chord_progression:
        raise SystemExit("--chord_progression is required without --batch_json")
    input_data = GenerationInput.from_dict({
        **{k: getattr(args, k) for k in META_KEYS},
        "output_dir": args.output_dir,
        "num_generate": args.num_generate,
        "top_k": args.top_k,
        "temperature": args.temperature,
        "chord_progression": args.chord_progression,
    })
    out = pipeline.run(input_data, seed=args.seed, validate=not args.lenient)
    print(f"Generated files under: {out}", file=stdout)


if __name__ == "__main__":
    main()
