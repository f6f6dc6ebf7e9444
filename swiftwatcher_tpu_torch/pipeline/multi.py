"""Several videos at once.

Counterpart of swiftwatcher_tpu/pipeline/multi.py.  The reference counts
its videos one after another (__main__.py:21); across videos is where the
work scales out.  Each video keeps its own prefetcher, tracker and state,
and jobs run on worker threads: while one video's windows are read or
computed on the card, another's host tracking and CSV export proceed.
All of them launch on the device's current stream, as the JAX package's
videos share one dispatch queue, so their kernels run in the order the
threads queue them.  Under a mesh (run_kwargs["mesh"], parallel/mesh.py)
the videos share it as the JAX package's share theirs: its runs hold its
lock, so one video's sharded batch runs on the ranks at a time and the
collectives of two threads never interleave.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..config import PipelineConfig
from ..io.source import FrameSource
from .runner import VideoResult, run_video


def run_videos(
    jobs: Sequence[Tuple[FrameSource, Sequence[Tuple[int, int]]]],
    cfg: PipelineConfig,
    device: torch.device,
    max_concurrent: int = 2,
    per_video_kwargs: Optional[Callable[[int], dict]] = None,
    **run_kwargs,
) -> List[VideoResult]:
    """Run the (source, corners) jobs, up to max_concurrent at once, on
    `device`; the results in job order.

    run_kwargs go to every run_video call; what they hold (a
    segment_filter, say) is shared by the jobs and must be thread-safe.
    Per-video arguments (export_dir, checkpoint_path, profile_dir) come
    from per_video_kwargs(job_index)."""
    with ThreadPoolExecutor(max_workers=max(1, max_concurrent)) as ex:
        futures = []
        for i, (source, corners) in enumerate(jobs):
            kw = dict(run_kwargs)
            if per_video_kwargs is not None:
                kw.update(per_video_kwargs(i))
            futures.append(ex.submit(run_video, source, corners, cfg, device, **kw))
        return [f.result() for f in futures]
