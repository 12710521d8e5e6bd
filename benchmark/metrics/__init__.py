"""One reader per metric, found by the metric's name (spec.metric_reader).

Each module has read(ctx) -> number or None; its unit, the end-to-end
metric it moves and the cells it is read in are BENCHMARK.json's alone.
ctx is what run.py gathered: job_s, setup_s, jobs, phases and counters per
window job, peak_bytes, the reference's report, and with --trace 1 the
profiled job's reduced trace (trace.reduce_events plus its launch shapes).  A reader that finds nothing
to read returns None and the metric is left out of the line."""
