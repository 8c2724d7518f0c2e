"""JPEG input: folder scanning and decoding.

The port's copy of the JAX package's `io/jpeg.py` (same names, signatures,
results, warnings and errors; held equal by tests/test_torch_io.py).

Mirrors the reference's intake behavior (encoder.h:140-171): files whose
names *contain* ".jpg"/".jpeg" (strstr semantics), in readdir order
(os.scandir preserves it on the same filesystem), with per-file skip on
decode failure and a dimension-match check (image_processing.c:48-66).

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
import warnings

import numpy as np

from ec504_imageencoder_tpu_torch.io import _native as native_build

_native = None


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
        lib.stbj_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.stbj_decode_batch.restype = ctypes.c_int
        lib.stbj_probe_file.argtypes = [ctypes.c_char_p] + [
            ctypes.POINTER(ctypes.c_int)
        ] * 7
        lib.stbj_probe_file.restype = ctypes.c_int
        staged = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.stbj_decode_planes_batch.argtypes = staged + [
            ctypes.POINTER(ctypes.c_ubyte)] * 3 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.stbj_decode_planes_batch.restype = ctypes.c_int
        lib.stbj_decode_coeffs_batch.argtypes = staged + [
            ctypes.POINTER(ctypes.c_int16)] * 3 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.stbj_decode_coeffs_batch.restype = ctypes.c_int
        _native = lib
    return _native


def probe_jpeg(path: str) -> dict | None:
    """Header-only geometry probe: {width, height, ncomp, chroma_w,
    chroma_h, hsamp, vsamp}; None if the file fails to parse."""
    lib = _load_native()
    vals = [ctypes.c_int() for _ in range(7)]
    if not lib.stbj_probe_file(path.encode(), *vals):
        return None
    w, h, ncomp, cw, ch, hs, vs = (v.value for v in vals)
    return {"width": w, "height": h, "ncomp": ncomp,
            "chroma_w": cw, "chroma_h": ch, "hsamp": hs, "vsamp": vs}


def _staged_batch(paths, geom, n_threads, kind):
    """Shared driver for the planes/coeffs batch decoders.  Raises on any
    per-file failure (streaming intakes are fail-fast; io/stream.py)."""
    lib = _load_native()
    n = len(paths)
    w, h = geom["width"], geom["height"]
    cw, ch = geom["chroma_w"], geom["chroma_h"]
    if kind == "planes":
        y = np.empty((n, h, w), np.uint8)
        cb = np.empty((n, ch, cw), np.uint8)
        cr = np.empty((n, ch, cw), np.uint8)
        fn, cty = lib.stbj_decode_planes_batch, ctypes.c_ubyte
    else:
        ybh, ybw = -(-h // 8), -(-w // 8)
        cbh, cbw = -(-ch // 8), -(-cw // 8)
        y = np.empty((n, ybh * ybw, 64), np.int16)
        cb = np.empty((n, cbh * cbw, 64), np.int16)
        cr = np.empty((n, cbh * cbw, 64), np.int16)
        fn, cty = lib.stbj_decode_coeffs_batch, ctypes.c_int16
    st = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    fn(
        c_paths, n, w, h, cw, ch,
        y.ctypes.data_as(ctypes.POINTER(cty)),
        cb.ctypes.data_as(ctypes.POINTER(cty)),
        cr.ctypes.data_as(ctypes.POINTER(cty)),
        st.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n_threads,
    )
    bad = np.nonzero(st != 0)[0]
    if bad.size:
        i = int(bad[0])
        kinds = {1: "decode failure", 2: "dimension mismatch",
                 3: "unsupported component layout"}
        raise ValueError(f"{kinds.get(int(st[i]), 'error')}: {paths[i]}")
    return y, cb, cr


def decode_planes_batch(paths: list[str], geom: dict, n_threads: int = 0):
    """Threaded batch decode to YCbCr planes (entropy decode + IDCT on
    the host, no resample/color): (Y (n,h,w), Cb, Cr (n,ch,cw)) u8.
    Half the bytes of RGB — the preferred intake for the MPEG encoder,
    which wants 4:2:0 YCbCr anyway."""
    return _staged_batch(paths, geom, n_threads, "planes")


def decode_coeffs_batch(paths: list[str], geom: dict, n_threads: int = 0):
    """Threaded batch decode to dequantized int16 coefficient blocks
    (host does entropy decode ONLY): (n, blocks, 64) per component.
    Feed to ops.jpeg_device.decode_planes_from_coeffs or
    TorchMPEG1IntraEncoder.encode_from_coeffs for the device back half."""
    return _staged_batch(paths, geom, n_threads, "coeffs")


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
        rest = paths[1:]
        c_paths = (ctypes.c_char_p * (n - 1))(*[p.encode() for p in rest])
        lib.stbj_decode_batch(
            c_paths, n - 1, w, h,
            out[1:].ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            st[1:].ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            n_threads,
        )
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
