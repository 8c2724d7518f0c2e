"""`TorchMPEG1IntraEncoder.encode_from_coeffs`: host int16 JPEG
coefficients in (the IDCT and padding run on the device), the video
elementary stream's bytes out (the CLI's coefficients intake)."""

from __future__ import annotations


def make(config: dict, mix: dict, device: str):
    from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder

    enc = TorchMPEG1IntraEncoder(quality=mix["quality"], frame_rate_code=config["frame_rate_code"],
                                 gop_size=config["gop_size"], device=device)

    def call(batch: dict, first_frame_index: int) -> bytes:
        return enc.encode_from_coeffs(batch["yc"], batch["cbc"], batch["crc"], config["height"],
                                      config["width"], first_frame_index=first_frame_index)

    return call
