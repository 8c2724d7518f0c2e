"""`TorchMPEG1IntraEncoder.encode_from_planes`: host 4:2:0 planes in, the
video elementary stream's bytes out (the CLI's planes intake)."""

from __future__ import annotations


def make(config: dict, mix: dict, device: str):
    from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder

    enc = TorchMPEG1IntraEncoder(quality=mix["quality"], frame_rate_code=config["frame_rate_code"],
                                 gop_size=config["gop_size"], device=device)

    def call(batch: dict, first_frame_index: int) -> bytes:
        return enc.encode_from_planes(batch["y"], batch["cb"], batch["cr"],
                                      first_frame_index=first_frame_index)

    return call
