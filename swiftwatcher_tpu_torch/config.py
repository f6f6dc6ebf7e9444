"""The pipeline configuration, shared with the JAX package.

swiftwatcher_tpu/config.py imports neither JAX nor pandas, so the port
uses its `PipelineConfig` as it is: one config object drives both
packages.  The port's modules and scripts import it from here.
"""

from swiftwatcher_tpu.config import DEFAULT_CONFIG, PipelineConfig

__all__ = ["DEFAULT_CONFIG", "PipelineConfig"]
