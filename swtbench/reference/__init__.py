"""The plain reference that decides `correct`.

A straightforward restatement of the original swiftwatcher pipeline
(joshuacwnewton/swiftwatcher: image_filtering.py, data_structures.py,
segment_tracking.py, event_classification.py, segment_classification.py)
in plain PyTorch, NumPy, SciPy, OpenCV and PIL, the libraries the original
calls.  It imports nothing of
the program under test and none of its oracles or test helpers.  It is
handed the stream's whole first frame and its gray crops and works
everything out again from those: the crop and ROI regions, the ROI mask,
the stabilisation's shifts, the IALM decomposition (float64, or the
control's float32 with TF32 products), the post-filter, the connected
components and their centroids, the segment filter's logits and keep
decisions where the configuration names one (handed the stream's whole
frames too), the tracker, the events and their labels.
"""

from .pipeline import run_reference

__all__ = ["run_reference"]
