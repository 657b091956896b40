"""Per-layer metrics, one a file named after the metric in BENCHMARK.json:
read(ctx) returns the metric's value from the traced window, or None when
the run holds nothing for it to read. ctx carries `reading` (trace.Reading
or None), `window` (loadgen.Window), `traced` (indices of the window's
requests issued and answered inside the trace), `tracer`, `data` and
`build_phases` (the graph build's seconds by phase, or None)."""
