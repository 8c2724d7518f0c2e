"""JPEG input: folder scanning and decoding.

The port's copy of the JAX package's `io/jpeg.py` (same names, signatures,
results, warnings and errors; held equal by tests/test_torch_io.py).

Mirrors the reference's intake behavior (encoder.h:140-171): files whose
names *contain* ".jpg"/".jpeg" (strstr semantics), in readdir order
(os.scandir preserves it on the same filesystem), with per-file skip on
decode failure and a dimension-match check (image_processing.c:48-66).

Beyond the reference, every batch decode (`decode_batch` and its
planes and coefficients forms, the folder loaders) takes JPEG files by
path or JPEGs in memory (bytes-like buffers) alike: a path is read into
memory first, and one native entry point (`stbj_decode_batch_mem`)
decodes every batch.  `intake_kind` is the one rule that picks what the
JPEG entry points decode to.

The decoder is the native stb-compatible one
(`io/native/stb_compat_jpeg.cpp`, built with g++ at first use by
`io/_native.py`): it matches the reference's vendored stb_image output
byte-for-byte, which the compat bit-exactness gate requires (stb's
IDCT/upsample/YCbCr math differs from libjpeg's).  A failed build raises.  Only a file the native
decoder rejects goes to PIL/libjpeg (pixel values may differ by +-1 from
stb; fine for correct-mode encoding), and only with require_exact=False;
where PIL is not installed, that file is a decode failure.
"""

from __future__ import annotations

import ctypes
import os
import threading
import warnings
from collections import Counter

import numpy as np

from ec504_imageencoder_tpu_torch.io import _native as native_build

_native = None

# the `intake` values of the JPEG entry points, and what each decodes to
INTAKES = ("auto", "rgb", "ycbcr", "coeffs")
_STAGES = {"coeffs": 0, "planes": 1, "rgb": 2}  # stbj_decode_batch_mem's stage
_FAILURES = {1: "decode failure", 2: "dimension mismatch", 3: "unsupported component layout"}

# what the batch decodes decoded since the last reset: frames by what they
# were decoded to ("planes", "coeffs", "rgb"), their JPEG bytes, their
# entropy-coded segments (one a scan, one more a restart marker), and the
# worker threads of the last batch
frames_decoded: Counter[str] = Counter()
bytes_in = 0
restart_intervals = 0
decode_threads = 0
_counting = threading.Lock()  # a stream's lookahead thread decodes beside its caller


def _load_native():
    """The native decoder's library, built and bound on first use."""
    global _native
    if _native is None:
        lib = native_build.load("stbjpeg")
        lib.stbj_decode_file.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.stbj_decode_file.restype = ctypes.POINTER(ctypes.c_ubyte)
        lib.stbj_free.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
        lib.stbj_probe_mem.argtypes = [ctypes.c_void_p, ctypes.c_long] + [
            ctypes.POINTER(ctypes.c_int)
        ] * 7
        lib.stbj_probe_mem.restype = ctypes.c_int
        lib.stbj_decode_batch_mem.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_long),
            ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ]
        lib.stbj_decode_batch_mem.restype = ctypes.c_int
        _native = lib
    return _native


def _is_path(src) -> bool:
    return isinstance(src, (str, os.PathLike))


def source_name(jpegs, i: int) -> str:
    """How an error names frame i of a batch: its path, or its index."""
    return str(jpegs[i]) if _is_path(jpegs[i]) else f"JPEG {i} of the batch"


def _jpeg_bytes(src) -> np.ndarray:
    """A JPEG as a u8 array: a path's file read into memory (empty where it
    cannot be read, which the decoder reports as a decode failure), or a
    bytes-like buffer as it is, without a copy."""
    if _is_path(src):
        try:
            with open(src, "rb") as f:
                src = f.read()
        except OSError:
            src = b""
    return np.frombuffer(src, np.uint8)


def probe_jpeg(src) -> dict | None:
    """Header-only geometry probe of a JPEG file (a path) or of a JPEG in
    memory (a bytes-like buffer): {width, height, ncomp, chroma_w,
    chroma_h, hsamp, vsamp}; None if it fails to parse."""
    lib = _load_native()
    data = _jpeg_bytes(src)
    vals = [ctypes.c_int() for _ in range(7)]
    if not lib.stbj_probe_mem(data.ctypes.data, data.size, *vals):
        return None
    w, h, ncomp, cw, ch, hs, vs = (v.value for v in vals)
    return {"width": w, "height": h, "ncomp": ncomp,
            "chroma_w": cw, "chroma_h": ch, "hsamp": hs, "vsamp": vs}


def intake_kind(geom: dict | None, intake: str = "auto") -> str:
    """The one intake rule of the JPEG entry points (`encode_from_jpegs`,
    `api.encode_jpeg_folder`, the CLI's `--stream`): what JPEGs of probed
    geometry `geom` (None: not probed by the native decoder) are decoded
    to.  "auto" and "ycbcr" take the 4:2:0 planes of 3-component
    2x2-subsampled JPEGs, "coeffs" their coefficients, anything else the
    RGB frames; "ycbcr" and "coeffs" raise ValueError on other layouts.
    -> "planes", "coeffs" or "rgb"."""
    if intake not in INTAKES:
        raise ValueError(f"unknown intake {intake!r}")
    staged = bool(geom and geom["ncomp"] == 3 and geom["hsamp"] == 2
                  and geom["vsamp"] == 2)
    if intake in ("ycbcr", "coeffs") and not staged:
        raise ValueError(
            f"intake {intake!r} needs 3-component 2x2-subsampled JPEGs "
            "and the native staged decoder"
        )
    if intake == "coeffs":
        return "coeffs"
    return "planes" if staged and intake != "rgb" else "rgb"


def _outputs(n: int, w: int, h: int, cw: int, ch: int, kind: str) -> tuple:
    """Empty host arrays for n frames decoded to `kind`."""
    if kind == "rgb":
        return (np.empty((n, h, w, 3), np.uint8),)
    if kind == "planes":
        return (np.empty((n, h, w), np.uint8), np.empty((n, ch, cw), np.uint8),
                np.empty((n, ch, cw), np.uint8))
    yb, cb = -(-h // 8) * -(-w // 8), -(-ch // 8) * -(-cw // 8)
    return (np.empty((n, yb, 64), np.int16), np.empty((n, cb, 64), np.int16),
            np.empty((n, cb, 64), np.int16))


def decode_with_status(jpegs, geom, kind, n_threads, outs=None):
    """-> (the outputs, each frame's status) of the native batch decode of
    `jpegs` (paths or bytes-like buffers, in any mix) to `kind` ("planes",
    "coeffs" or "rgb"; geom: {width, height} and for the staged kinds
    {chroma_w, chroma_h}), into `outs` where given: every frame of every
    caller takes this path.  Status 0 ok, else a key of `_FAILURES`."""
    global bytes_in, restart_intervals, decode_threads
    lib = _load_native()
    n = len(jpegs)
    w, h = geom["width"], geom["height"]
    cw, ch = (geom["chroma_w"], geom["chroma_h"]) if kind != "rgb" else (0, 0)
    if outs is None:
        outs = _outputs(n, w, h, cw, ch, kind)
    data = [_jpeg_bytes(j) for j in jpegs]  # held until the decode returns
    lens = np.array([d.size for d in data], np.int64)
    status = np.zeros(n, np.int32)
    segments = np.zeros(n, np.int32)
    ptrs = [o.ctypes.data for o in outs] + [None] * (3 - len(outs))
    threads = lib.stbj_decode_batch_mem(
        (ctypes.c_void_p * n)(*[d.ctypes.data for d in data]),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        n, _STAGES[kind], w, h, cw, ch, *ptrs,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        segments.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n_threads,
    )
    ok = status == 0
    with _counting:
        frames_decoded[kind] += int(ok.sum())
        bytes_in += int(lens[ok].sum())
        restart_intervals += int(segments[ok].sum())
        decode_threads = threads
    return outs, status


def decode_batch(jpegs, geom: dict, kind: str, n_threads: int = 0):
    """Threaded batch decode of JPEG files (paths) or JPEGs in memory
    (bytes-like buffers: bytes, bytearray, memoryview, u8 arrays) to
    `kind`: "planes" (Y (n,h,w), Cb, Cr (n,ch,cw) u8), "coeffs" ((n,
    blocks, 64) int16 per component) or "rgb" (((n,h,w,3) u8,)).  Every
    frame must have `geom`'s geometry.  Fail-fast: the first frame that
    fails raises ValueError naming its path, or its index in the batch.
    n_threads=0: one thread per hardware thread (`decode_threads` counts
    the threads used)."""
    outs, status = decode_with_status(jpegs, geom, kind, n_threads)
    bad = np.nonzero(status != 0)[0]
    if bad.size:
        i = int(bad[0])
        raise ValueError(f"{_FAILURES.get(int(status[i]), 'error')}: {source_name(jpegs, i)}")
    return outs


def decode_planes_batch(paths: list, geom: dict, n_threads: int = 0):
    """Threaded batch decode to YCbCr planes (entropy decode + IDCT on
    the host, no resample/color): (Y (n,h,w), Cb, Cr (n,ch,cw)) u8.
    Half the bytes of RGB — the preferred intake for the MPEG encoder,
    which wants 4:2:0 YCbCr anyway.  paths: paths or bytes-like buffers
    (`decode_batch`)."""
    return decode_batch(paths, geom, "planes", n_threads)


def decode_coeffs_batch(paths: list, geom: dict, n_threads: int = 0):
    """Threaded batch decode to dequantized int16 coefficient blocks
    (host does entropy decode ONLY): (n, blocks, 64) per component.
    Feed to ops.jpeg_device.decode_planes_from_coeffs or
    TorchMPEG1IntraEncoder.encode_from_coeffs for the device back half.
    paths: paths or bytes-like buffers (`decode_batch`)."""
    return decode_batch(paths, geom, "coeffs", n_threads)


def have_native_decoder() -> bool:
    return _load_native() is not None


def decode_jpeg(path: str, require_exact: bool = False) -> np.ndarray:
    """Decode one JPEG to (H, W, 3) uint8 RGB."""
    lib = _load_native()
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    ptr = lib.stbj_decode_file(path.encode(), w, h, c)
    if ptr:
        try:
            n = w.value * h.value * c.value
            arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
        finally:
            lib.stbj_free(ptr)
        img = arr.reshape(h.value, w.value, c.value)
        return img[..., :3] if c.value >= 3 else np.repeat(img, 3, axis=-1)
    if require_exact:
        raise RuntimeError(
            f"compat mode requires the stb-compatible native JPEG decoder, "
            f"which rejected {path}; PIL output is not bit-exact against "
            "the reference"
        )
    try:
        from PIL import Image
    except ImportError as e:
        raise ValueError(
            f"decode failure: {path} (rejected by the native decoder; PIL, "
            "the fallback, is not installed)"
        ) from e

    warnings.warn(
        "using PIL JPEG decoding; pixels may differ slightly from the "
        "reference's stb_image (compat bitstreams will not be bit-exact)",
        stacklevel=2,
    )
    return np.asarray(Image.open(path).convert("RGB"))


def scan_folder(folder: str) -> list[str]:
    """Image paths in readdir order with the reference's strstr filter."""
    out = []
    for entry in os.scandir(folder):
        if ".jpg" in entry.name or ".jpeg" in entry.name:
            out.append(entry.path)
    return out


def _load_folder_native_batch(
    paths: list[str], n_threads: int
) -> tuple[np.ndarray, list[str]] | None:
    """Threaded native batch decode straight into one contiguous buffer.

    Returns None when the probe file fails; caller falls back to the
    sequential path.
    """
    lib = _load_native()
    # probe (natively, so all frames share one decoder) for expected dims;
    # the probe's pixels are kept as frame 0 so it is not decoded twice
    pw, ph, pc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    ptr = lib.stbj_decode_file(paths[0].encode(), pw, ph, pc)
    if not ptr:
        return None
    h, w, c = ph.value, pw.value, pc.value
    n = len(paths)
    out = np.empty((n, h, w, 3), np.uint8)
    try:
        probe = np.ctypeslib.as_array(ptr, shape=(h, w, c))
        out[0] = probe[..., :3] if c >= 3 else probe[..., :1]
    finally:
        lib.stbj_free(ptr)
    st = np.zeros(n, np.int32)
    if n > 1:
        _, st[1:] = decode_with_status(paths[1:], {"width": w, "height": h}, "rgb",
                                       n_threads, (out[1:],))
    bad_dims = [paths[i] for i in range(n) if st[i] == 2]
    if bad_dims:
        raise ValueError(
            f"image dimensions do not match: {bad_dims[0]}, "
            f"expected {(h, w, 3)}"
        )
    keep = st == 0
    if keep.all():  # common case: no compaction copy
        return out, list(paths)
    for i in np.nonzero(~keep)[0]:
        warnings.warn(f"skipping {paths[i]}: decode failed", stacklevel=3)
    if not keep.any():
        raise ValueError("no decodable images found")
    return np.ascontiguousarray(out[keep]), [
        p for i, p in enumerate(paths) if keep[i]
    ]


def load_folder(
    folder: str, require_exact: bool = False, n_threads: int = 0
) -> tuple[np.ndarray, list[str]]:
    """Decode all JPEGs in a folder -> ((B, H, W, 3) u8, kept paths).

    Files that fail to decode are skipped (reference encoder.h:163-167);
    mismatched dimensions raise (image_processing.c:48-66 aborts).
    Uses the native threaded batch decoder (n_threads=0 means one per
    hardware core); falls back to sequential decode when the first file
    fails to decode or the batch decoder fails.
    """
    paths = scan_folder(folder)
    if not paths:
        raise ValueError(f"no decodable images found in {folder}")
    if len(paths) > 1:
        try:
            batched = _load_folder_native_batch(paths, n_threads)
        except ValueError:
            raise
        except Exception as e:
            warnings.warn(f"native batch decode failed ({e}); "
                          "falling back to sequential", stacklevel=2)
            batched = None
        if batched is not None:
            return batched
    frames = []
    names = []
    for path in paths:
        try:
            frames.append(decode_jpeg(path, require_exact))
            names.append(path)
        except RuntimeError:
            raise
        except Exception as e:  # skip-on-bad-image semantics
            warnings.warn(f"skipping {path}: {e}", stacklevel=2)
    if not frames:
        raise ValueError(f"no decodable images found in {folder}")
    shape = frames[0].shape
    for p, f in zip(names, frames):
        if f.shape != shape:
            raise ValueError(
                f"image dimensions do not match: {p} is {f.shape}, "
                f"expected {shape}"
            )
    return np.stack(frames), names
