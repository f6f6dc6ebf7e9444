"""Host-side I/O: frame sources, synthetic video, window streaming."""
