"""`TorchMPEG1IntraEncoder.encode`: host RGB frames in (colour and 4:2:0
run on the device), the video elementary stream's bytes out (the CLI's
RGB intake, `encode_video` and `api`)."""

from __future__ import annotations


def make(config: dict, mix: dict, device: str):
    from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder

    enc = TorchMPEG1IntraEncoder(quality=mix["quality"], frame_rate_code=config["frame_rate_code"],
                                 gop_size=config["gop_size"], device=device)

    def call(batch: dict, first_frame_index: int) -> bytes:
        return enc.encode(batch["rgb"], first_frame_index=first_frame_index)

    return call
