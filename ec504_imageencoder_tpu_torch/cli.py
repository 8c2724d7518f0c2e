"""Command-line interface of the PyTorch + CUDA port.

The port's counterpart of the JAX package's `mpeg-encode`
(`ec504_imageencoder_tpu/cli.py`): the reference's entry surface (main.c:15-17
/ mpeg_encode_procedure, encoder.h:20) plus correct mode, quality, GOP,
frame-rate, intake and mesh controls, with the same flags, defaults, help
and errors.  `--backend jax|numpy` is `--device cuda|cpu` here (default cuda:
without CUDA the command exits with an error, it never encodes on the CPU
unasked); `--debug-checks`, `--fuse` and `--pack` reach the encoder keywords
that the reference sets through EC504_DEBUG_CHECKS, EC504_FUSE and
EC504_VLC/EC504_PACK.

    python -m ec504_imageencoder_tpu_torch.cli images/ -o out.mpeg
    mpeg-encode-torch images/ -o awesome_video.mpeg --mode compat \
        --bitstream-dir bitstreams -q 12                   # reference parity
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

from ec504_imageencoder_tpu_torch.models.mpeg1 import PACKS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpeg-encode-torch",
        description="MPEG-1 intra-frame encoder on PyTorch + CUDA",
    )
    p.add_argument("images", help="folder of input JPEG frames")
    p.add_argument("-o", "--output", default="awesome_video.mpeg",
                   help="output .mpeg path")
    p.add_argument("--mode", choices=["correct", "compat"], default="correct",
                   help="'correct' = ISO-compliant stream; 'compat' = "
                        "bit-exact reproduction of the reference encoder")
    p.add_argument("-q", "--quality", type=int, default=None,
                   help="quality factor 1-100 (default: 12 in compat mode "
                        "to match the reference CLI, else 50)")
    p.add_argument("--bitstream-dir", default=None,
                   help="also write per-image raw YCbCr .bit dumps here "
                        "(reference behavior)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="'cuda' runs the CUDA kernels and fails where CUDA "
                        "is absent; 'cpu' runs their plain PyTorch twins")
    p.add_argument("--gop", type=int, default=15, help="GOP size (correct mode)")
    p.add_argument("--frame-rate-code", type=int, default=3,
                   help="MPEG-1 frame rate code (3 = 25fps)")
    p.add_argument("--batch", type=int, default=16,
                   help="frames per device batch (correct mode)")
    p.add_argument("--mesh", default=None,
                   help="use all devices as DATAxROWS mesh, e.g. '4,2' "
                        "(--device cpu: that many CPU entries)")
    p.add_argument("--workdir", default=None,
                   help="checkpointed encode: write per-GOP segments + "
                        "manifest here and resume any interrupted run")
    p.add_argument("--dct", choices=["auto", "aan", "f32"], default="auto",
                   help="DCT kernel (correct mode): integer AAN or f32")
    p.add_argument("--color-range", choices=["studio", "full"], default="studio",
                   help="correct mode: 'studio' = BT.601 limited range "
                        "(16-235, what standard MPEG-1 players assume); "
                        "'full' = reference JPEG-style full range")
    p.add_argument("--container", choices=["es", "ps"], default="es",
                   help="correct mode: elementary stream or MPEG-1 program "
                        "stream (pack/PES mux, like the reference's container)")
    p.add_argument("--stream", action="store_true",
                   help="correct mode: bounded-memory intake — decode "
                        "JPEG batches on demand (with lookahead prefetch) "
                        "instead of loading the whole folder upfront")
    p.add_argument("--intake", choices=["auto", "rgb", "ycbcr", "coeffs"],
                   default="auto",
                   help="correct-mode --stream intake: 'ycbcr' feeds the "
                        "JPEGs' own 4:2:0 planes straight to the encoder "
                        "(half the host->device bytes, no RGB round "
                        "trip); 'coeffs' ships dequantized coefficient "
                        "blocks and runs the JPEG IDCT on device (weak "
                        "host, fast link); 'auto' uses ycbcr when the "
                        "JPEGs are 3-component 2x2-subsampled and no "
                        ".bit dumps were requested")
    p.add_argument("--debug-checks", action="store_true",
                   help="sanitizer: check every VLC slot and pack invariant "
                        "on the device (same bytes; a violation is an error)")
    p.add_argument("--fuse", type=int, choices=[4, 8], default=4,
                   help="correct mode, AAN route: 4:1 or 8:1 slot fusion "
                        "(same bytes)")
    p.add_argument("--pack", choices=list(PACKS), default="fused4",
                   help="correct mode: 'fused4' = the fused-slot routes; the "
                        "others run the generic route with that raw-code "
                        "pack kernel (same bytes)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace (Chrome trace JSON) "
                        "of the encode into DIR")
    p.add_argument("--metrics", action="store_true",
                   help="print per-stage metrics to stderr")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ec504_imageencoder_tpu_torch.device import resolve_device
    from ec504_imageencoder_tpu_torch.io.jpeg import load_folder
    from ec504_imageencoder_tpu_torch.utils.metrics import EncodeMetrics

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"mpeg-encode-torch: {e}") from e
    quality = args.quality
    metrics = EncodeMetrics()

    use_stream = args.stream and args.mode == "correct"
    if args.intake in ("ycbcr", "coeffs") and (not use_stream or args.workdir
                                               or args.bitstream_dir):
        # fail loudly rather than silently running the RGB intake the
        # user asked to avoid
        raise SystemExit(
            f"--intake {args.intake} requires correct-mode --stream "
            "without --workdir/--bitstream-dir"
        )
    t0 = time.perf_counter()
    if use_stream:
        from ec504_imageencoder_tpu_torch.io.stream import FolderFrameSource

        source = FolderFrameSource(args.images)
        n_frames, res_w, res_h = len(source), source.width, source.height
        frames = None
    else:
        frames, names = load_folder(args.images, require_exact=False)
        n_frames, res_h, res_w = len(frames), frames.shape[1], frames.shape[2]
        source = lambda s, e: frames[s:e]  # noqa: E731
    metrics.add("decode_s", time.perf_counter() - t0)
    metrics.set("frames", n_frames)
    metrics.set("resolution", f"{res_w}x{res_h}")

    from ec504_imageencoder_tpu_torch.utils.profiling import device_trace

    with device_trace(args.profile) if args.profile else contextlib.nullcontext():
        t0 = time.perf_counter()
        if args.mode == "compat":
            from ec504_imageencoder_tpu_torch.models.encoder import encode_compat

            data, dumps = encode_compat(
                frames, 12 if quality is None else quality, device=device,
                debug_checks=args.debug_checks,
            )
        else:
            data, dumps = _encode_correct(args, device, metrics, source, frames,
                                          n_frames, res_w, res_h, use_stream)
        metrics.add("encode_s", time.perf_counter() - t0)

    with open(args.output, "wb") as f:
        f.write(data)
    metrics.set("stream_bytes", len(data))

    if args.bitstream_dir and dumps:
        os.makedirs(args.bitstream_dir, exist_ok=True)
        for i, d in enumerate(dumps):
            with open(os.path.join(args.bitstream_dir, f"image_{i + 1}.bit"), "wb") as f:
                f.write(d)

    print(f"wrote {args.output}: {len(data)} bytes, {n_frames} frames")
    if args.metrics:
        print(metrics.report(), file=sys.stderr)
    return 0


def _encode_correct(args, device, metrics, source, frames, n_frames, res_w, res_h,
                    use_stream):
    """Correct mode: (stream bytes, .bit dumps or None)."""
    import torch

    from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder
    from ec504_imageencoder_tpu_torch.syntax import headers

    kw = dict(
        quality=50 if args.quality is None else args.quality,
        frame_rate_code=args.frame_rate_code,
        gop_size=args.gop,
        dct_impl=args.dct,
        color_range=args.color_range,
        debug_checks=args.debug_checks,
        fuse=args.fuse,
        pack=args.pack,
    )
    if args.mesh:
        from ec504_imageencoder_tpu_torch.parallel import mesh as mesh_lib
        from ec504_imageencoder_tpu_torch.parallel.sharded_encoder import (
            ShardedTorchMPEG1Encoder,
        )

        nd, nr = (int(x) for x in args.mesh.split(","))
        devices = ["cpu"] * (nd * nr) if device.type == "cpu" else None
        mesh = mesh_lib.make_mesh(nd, nr, devices)
        enc = ShardedTorchMPEG1Encoder(mesh=mesh, **kw)
        n_devices = len(mesh.distinct_devices())
    else:
        enc = TorchMPEG1IntraEncoder(device=device, **kw)
        n_devices = torch.cuda.device_count() if device.type == "cuda" else None
    if args.metrics:
        enc.metrics = metrics
        if n_devices is not None:
            metrics.set("n_devices", n_devices)
    if args.workdir:
        from ec504_imageencoder_tpu_torch.runtime.checkpoint import encode_resumable

        encode_resumable(
            source, n_frames, args.workdir,
            args.output, encoder=enc, metrics=metrics,
        )
        with open(args.output, "rb") as f:
            data = f.read()
    elif use_stream:
        # bounded-memory path: decode batch N+1 while encoding batch N, by
        # the intake rule of encode_from_jpegs and api.encode_jpeg_folder
        from ec504_imageencoder_tpu_torch.api import encode_frame_source
        from ec504_imageencoder_tpu_torch.io.jpeg import intake_kind

        try:  # .bit dumps need the RGB frames
            kind = intake_kind(source.geometry, "rgb" if args.bitstream_dir else args.intake)
        except ValueError as e:
            raise SystemExit(
                f"--intake {args.intake} needs 3-component "
                "2x2-subsampled JPEGs and the native staged decoder"
            ) from e
        data = encode_frame_source(enc, source, args.batch, kind) + headers.sequence_end()
    else:
        chunks = []
        for start in range(0, n_frames, args.batch):
            chunks.append(
                enc.encode(frames[start : start + args.batch], first_frame_index=start))
        data = b"".join(chunks) + headers.sequence_end()
    if args.container == "ps":
        from ec504_imageencoder_tpu_torch.syntax import mux

        pics = mux.split_es_pictures(data[: -len(headers.sequence_end())])
        data = mux.mux_program_stream(pics, fps=enc.fps)
    dumps = None
    if args.bitstream_dir:
        from ec504_imageencoder_tpu_torch.ops.color import rgb_to_ycbcr_exact

        dumps = []
        for start in range(0, n_frames, args.batch):
            chunk = source(start, min(start + args.batch, n_frames))
            y, cb, cr = rgb_to_ycbcr_exact(chunk)
            dumps += [
                headers.raw_plane_dump(
                    res_w, res_h,
                    y[i].reshape(-1), cb[i].reshape(-1), cr[i].reshape(-1),
                )
                for i in range(len(chunk))
            ]
    return data, dumps


if __name__ == "__main__":
    sys.exit(main())
