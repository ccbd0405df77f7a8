"""One reader a per-layer metric, found by the metric's name in
BENCHMARK.json: metrics/<name>.py's read(s) takes the traced stretch
(tracing.Stretch) and returns the metric's value, or None where the
stretch holds nothing for it to read."""
