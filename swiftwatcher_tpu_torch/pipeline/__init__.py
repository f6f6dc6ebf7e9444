"""Window program, event classification, per-video orchestration."""
