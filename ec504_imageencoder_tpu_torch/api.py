"""Top-level convenience API, including the reference's exact entry point.

The port's counterpart of the JAX package's `api.py`: the same functions,
arguments, outputs and return conventions, with `device` ("cuda", the
default, or "cpu") where the reference takes `backend`.  Nothing falls
back from the card to the CPU: on a machine without CUDA, the default
raises RuntimeError.

`mpeg_encode_procedure` is a drop-in for the reference C project's entry
point (include/encoder.h:20, called by main.c and the JNI shim): same
arguments, same on-disk outputs (the .mpeg system stream + per-image .bit
plane dumps), same return convention (0 = success), byte-exact output in
compat mode.
"""

from __future__ import annotations

import os

import numpy as np

from ec504_imageencoder_tpu_torch.device import resolve_device


def mpeg_encode_procedure(
    images_folder: str,
    bitstream_folder: str,
    video_path: str,
    quality_factor: int = 12,
    device="cuda",
) -> int:
    """Encode every JPEG in `images_folder` to `video_path` (compat mode)
    and write per-image raw YCbCr dumps into `bitstream_folder`."""
    from ec504_imageencoder_tpu_torch.io.jpeg import load_folder
    from ec504_imageencoder_tpu_torch.models.encoder import encode_compat

    dev = resolve_device(device)
    try:
        frames, _ = load_folder(images_folder)
    except (FileNotFoundError, ValueError) as e:
        print(f"Error: {e}")
        return 1
    data, dumps = encode_compat(frames, quality_factor, device=dev)
    os.makedirs(bitstream_folder, exist_ok=True)
    parent = os.path.dirname(video_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(video_path, "wb") as f:
        f.write(data)
    for i, d in enumerate(dumps):
        with open(os.path.join(bitstream_folder, f"image_{i + 1}.bit"), "wb") as f:
            f.write(d)
    return 0


def encode_video(
    frames: np.ndarray,
    path: str,
    quality: int = 50,
    fps: float = 25.0,
    gop_size: int = 15,
    device="cuda",
    bit_rate: int | None = None,
) -> int:
    """One-call ISO-compliant encode of (B, H, W, 3) uint8 frames.  An fps
    with no MPEG-1 frame-rate code maps to code 3 (25 fps), as in the
    reference (ROADMAP C-r2).  bit_rate (bit/s, beyond the reference): the
    encoder's rate control, every picture coded to exactly bit_rate / fps
    (`TorchMPEG1IntraEncoder`)."""
    from ec504_imageencoder_tpu_torch.models.mpeg1 import (
        FRAME_RATE_CODES,
        TorchMPEG1IntraEncoder,
    )

    code = FRAME_RATE_CODES.get(fps, 3)
    enc = TorchMPEG1IntraEncoder(
        quality=quality, frame_rate_code=code, gop_size=gop_size, device=device,
        bit_rate=bit_rate,
    )
    return enc.encode_to_file(frames, path)


def encode_jpegs(
    jpegs,
    path: str,
    quality: int = 50,
    fps: float = 25.0,
    gop_size: int = 15,
    batch_size: int = 16,
    intake: str = "auto",
    device="cuda",
) -> int:
    """One-call ISO-compliant encode of JPEGs held in memory (a list of
    bytes-like buffers, e.g. frames from a camera or a network) into a
    video ES file, `batch_size` at a time through
    `TorchMPEG1IntraEncoder.encode_from_jpegs`: the intake rule and the
    decode of `encode_jpeg_folder`, with no file in between.  Returns
    bytes written.  A widening beyond the JAX package, whose entry points
    take a folder or decoded frames only."""
    from ec504_imageencoder_tpu_torch.models.mpeg1 import (
        FRAME_RATE_CODES,
        TorchMPEG1IntraEncoder,
    )
    from ec504_imageencoder_tpu_torch.syntax import headers

    enc = TorchMPEG1IntraEncoder(
        quality=quality, frame_rate_code=FRAME_RATE_CODES.get(fps, 3),
        gop_size=gop_size, device=device,
    )
    chunks = [enc.encode_from_jpegs(jpegs[s:s + batch_size], first_frame_index=s,
                                    intake=intake)
              for s in range(0, len(jpegs), batch_size)]
    return _write(path, b"".join(chunks) + headers.sequence_end())


def encode_frame_source(enc, src, batch_size: int, kind: str) -> bytes:
    """The streaming encode of a `FolderFrameSource`: each batch decoded
    to `kind` (`io/jpeg.py::intake_kind`'s answer) by the source's
    one-batch lookahead, then coded by `models/mpeg1.py::encode_decoded`.
    The encode of `encode_jpeg_folder` and the CLI's `--stream`; the ES
    without its sequence end code."""
    from ec504_imageencoder_tpu_torch.models.mpeg1 import encode_decoded

    if kind == "rgb":
        batches = ((start, (frames,)) for start, frames in src.batches(batch_size))
    else:
        batches = {"planes": src.plane_batches, "coeffs": src.coeff_batches}[kind](batch_size)
    return b"".join(encode_decoded(enc, kind, arrays, src.geometry, start)
                    for start, arrays in batches)


def encode_jpeg_folder(
    images_folder: str,
    path: str,
    quality: int = 50,
    fps: float = 25.0,
    gop_size: int = 15,
    batch_size: int = 16,
    intake: str = "auto",
    device="cuda",
) -> int:
    """One-call ISO-compliant streaming encode of a JPEG folder.

    Bounded memory (one batch + one prefetched batch); picks the
    fastest supported intake — `ycbcr` feeds the JPEGs' own 4:2:0
    planes straight to the device pipeline (half the host->device
    bytes, no RGB round trip), `coeffs` ships entropy-decoded
    coefficients and runs the JPEG IDCT on device, `rgb` is the
    universal fallback.  Returns bytes written.

    As in the reference, "auto" takes the planes for 4:2:0 JPEGs, which
    store the JPEG's full-range YCbCr where the rgb intake stores studio
    range (ROADMAP C-r1), and an fps with no frame-rate code maps to
    code 3 (C-r2)."""
    from ec504_imageencoder_tpu_torch.io import jpeg as jpeg_io
    from ec504_imageencoder_tpu_torch.io.stream import FolderFrameSource
    from ec504_imageencoder_tpu_torch.models.mpeg1 import (
        FRAME_RATE_CODES,
        TorchMPEG1IntraEncoder,
    )
    from ec504_imageencoder_tpu_torch.syntax import headers

    dev = resolve_device(device)
    src = FolderFrameSource(images_folder)
    kind = jpeg_io.intake_kind(src.geometry, intake)
    enc = TorchMPEG1IntraEncoder(
        quality=quality, frame_rate_code=FRAME_RATE_CODES.get(fps, 3),
        gop_size=gop_size, device=dev,
    )
    return _write(path, encode_frame_source(enc, src, batch_size, kind)
                  + headers.sequence_end())


def _write(path: str, data: bytes) -> int:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)
