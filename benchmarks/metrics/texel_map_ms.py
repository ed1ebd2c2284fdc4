"""Device milliseconds a texel run spends shading texel dose maps: the
device intervals of the traced slice's `shade.texel_map` spans (two CUDA
events each: the per-texel dose of the dose map, of the irradiance map and
of the map the texel grid reads), over the slice's whole runs. None where
the program has no such span."""

from benchmarks.harness.spans import in_record


def read(run):
    spans = in_record(run)
    maps = [] if spans is None else [s for s in spans if s.name == "shade.texel_map"]
    if not maps or any(s.device_ms is None for s in maps):
        return None
    return sum(s.device_ms for s in maps) / run.record["runs"]
