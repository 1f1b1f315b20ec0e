"""The share of its roofline that the upscale stage reaches: the stage's
least time (benchmark/upscale_work.py, counted from the sizes and weights
of field1m_1080.ai's configuration, the one cell BENCHMARK.json reports
it in) over `upscale_ms`, in percent. Nothing to read without the
program's upscale mark."""

from benchmark import harness, upscale_work
from benchmark.metrics import upscale_ms

KIND = "per_layer"
UNIT = "%"
CELL = "field1m_1080.ai"


def read(run):
    ms = upscale_ms.read(run)
    if not ms:
        return None
    _c, cfg, _t = harness.cell(CELL)
    return 100.0 * upscale_work.upscale_work(cfg).least_ms() / ms
