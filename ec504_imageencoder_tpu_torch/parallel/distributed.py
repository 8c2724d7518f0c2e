"""Multi-process distributed encoding on torch.distributed.

GOPs are fully independent byte segments (SURVEY.md §2.1), so processes
take GOPs round-robin, write checkpointed segment files
(runtime/checkpoint.py), meet at a barrier, and process 0 stitches the
final stream.  Within a process, the sharded encoder fans frames and rows
across local devices; the only cross-process traffic is the barrier and
the file-system segment gather.

Failure model: frames are independent — a lost process's pending GOPs are
simply absent from the manifest, and any restart (same workdir) encodes
exactly the missing ones.  `encode_multihost` therefore doubles as the
fault re-dispatch path.

The port's counterpart of the JAX package's `parallel/distributed.py`,
which uses jax.distributed for the rendezvous, the process index and the
barrier.  Here they are a torch.distributed process group on the gloo
backend: the only traffic is the barrier, which gloo serves from the host
without touching a card.
"""

from __future__ import annotations

import datetime
import os
import time

import torch.distributed as dist

from ec504_imageencoder_tpu_torch.models.mpeg1 import TorchMPEG1IntraEncoder
from ec504_imageencoder_tpu_torch.runtime.checkpoint import CheckpointedEncode
from ec504_imageencoder_tpu_torch.syntax import headers


def process_index_count() -> tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    timeout: float = 300.0,
) -> tuple[int, int]:
    """Initialize a gloo process group (env-driven when args are None).

    coordinator_address is "host:port" (or "tcp://host:port") of rank 0's
    store; without it torch's own rendezvous variables MASTER_ADDR and
    MASTER_PORT name it, and WORLD_SIZE and RANK stand in for
    num_processes and process_id.  timeout (seconds) bounds the
    rendezvous and every collective, so a missing peer fails instead of
    hanging.

    Returns (process_id, num_processes).  Safe to call in single-process
    mode (returns (0, 1) without initializing)."""
    if num_processes in (None, 1) and not coordinator_address and not os.environ.get(
        "MASTER_ADDR"
    ):
        return 0, 1
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    addr = coordinator_address.removeprefix("tcp://")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{addr}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout),
    )
    return process_index_count()


def barrier(name: str) -> None:
    """Cross-process barrier (`name` labels it for the reader, as the
    reference's sync_global_devices name does); a no-op without a process
    group."""
    if process_index_count()[1] > 1:
        dist.barrier()


def encode_multihost(
    frame_source,
    total_frames: int,
    workdir: str,
    out_path: str,
    encoder: TorchMPEG1IntraEncoder | None = None,
) -> int | None:
    """Encode across all processes; returns stream size on process 0.

    Each process encodes GOPs g with g % world size == rank into the
    shared `workdir` (its own manifest file avoids write races), then
    process 0 stitches every segment.  Without a process group the rank is
    0 and the world size 1.  encoder=None encodes with
    `TorchMPEG1IntraEncoder()`, on "cuda"."""
    pid, nproc = process_index_count()
    enc = encoder or TorchMPEG1IntraEncoder()
    sess = CheckpointedEncode(
        workdir, enc, total_frames
    )
    sess.manifest_path = os.path.join(workdir, f"manifest_{pid}.json")
    sess.segments = {}
    sess._load_manifest()

    for g in range(sess.n_gops()):
        if g % nproc != pid or g in sess.segments:
            continue
        start, end = sess.gop_frame_range(g)
        sess.encode_gop(g, frame_source(start, end))

    barrier("encode_complete")

    if pid != 0:
        return None

    # stitch: trust segment files named by GOP index; verify count
    total = 0
    with open(out_path, "wb") as out:
        for g in range(sess.n_gops()):
            path = os.path.join(workdir, f"seg_{g:06d}.m1vseg")
            deadline = time.time() + 30.0  # shared-fs visibility grace
            while not os.path.exists(path) and time.time() < deadline:
                time.sleep(0.2)
            if not os.path.exists(path):
                raise RuntimeError(f"missing segment for GOP {g}: {path}")
            with open(path, "rb") as f:
                total += out.write(f.read())
        total += out.write(headers.sequence_end())
    return total
