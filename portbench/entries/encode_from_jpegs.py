"""`TorchMPEG1IntraEncoder.encode_from_jpegs`: JPEG files in memory in
(the host's native decoder decodes them, then the intake the rule picks
codes them: the 4:2:0 planes of these files under "auto"), the video
elementary stream's bytes out (`api.encode_jpegs`, the CLI's `--stream`
and `api.encode_jpeg_folder` on files)."""

from __future__ import annotations


def make(config: dict, mix: dict, device: str):
    from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder

    enc = TorchMPEG1IntraEncoder(quality=mix["quality"], frame_rate_code=config["frame_rate_code"],
                                 gop_size=config["gop_size"], device=device)

    def call(batch: dict, first_frame_index: int) -> bytes:
        jpegs = [row[:n] for row, n in zip(batch["jpeg"], batch["length"])]
        return enc.encode_from_jpegs(jpegs, first_frame_index, intake=mix["intake"])

    return call
