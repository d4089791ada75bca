"""The benchmark's tests run on the CPU: a few torch threads a worker.

On the CPU the program takes its raster kernels' plain versions, which
count nothing; the fixture below counts their calls in the kernels' own
launch counters, so that a CPU run's check sees each frame rendered as a
run on the card does."""

import pytest
import torch

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def plain_rasters_count_as_launches(monkeypatch):
    from rustexp_tpu_torch.ops import raster_bins, raster_queue

    for mod, plain, kernel in (
            (raster_queue, "raster_attrs_queue_plain",
             raster_queue.raster_attrs_queue_cuda),
            (raster_bins, "raster_attrs_bins_plain",
             raster_bins.raster_attrs_bins_cuda)):
        fn = getattr(mod, plain)

        def counted(*args, _fn=fn, _kernel=kernel):
            _kernel.launches += 1
            return _fn(*args)

        monkeypatch.setattr(mod, plain, counted)
