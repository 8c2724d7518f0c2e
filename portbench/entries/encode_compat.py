"""`models.encoder.encode_compat`: RGB frames in, the system stream and
the per-frame `.bit` dumps out (the C project's `mpeg_encode_procedure`).
Each call is a whole procedure, so `first_frame_index` has no part in it."""

from __future__ import annotations


def make(config: dict, mix: dict, device: str):
    from ec504_imageencoder_tpu_torch.models.encoder import encode_compat

    def call(batch: dict, first_frame_index: int) -> tuple[bytes, list[bytes]]:
        return encode_compat(batch["rgb"], mix["quality"], device=device)

    return call
