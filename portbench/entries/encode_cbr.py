"""`TorchMPEG1IntraEncoder(bit_rate=).encode`: host RGB frames in, each
picture coded at the quantizer_scale that fits it to the configuration's
fixed picture size, the video elementary stream's bytes out (the CLI's
`--bit-rate`, `encode_video(bit_rate=)`)."""

from __future__ import annotations


def make(config: dict, mix: dict, device: str):
    from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder

    enc = TorchMPEG1IntraEncoder(quality=mix["quality"], frame_rate_code=config["frame_rate_code"],
                                 gop_size=config["gop_size"], bit_rate=config["bit_rate"],
                                 device=device)

    def call(batch: dict, first_frame_index: int) -> bytes:
        return enc.encode(batch["rgb"], first_frame_index=first_frame_index)

    return call
