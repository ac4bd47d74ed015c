#!/usr/bin/env python3
"""Time the host-to-card copy of streamed panels, two ways, on one card.

    python3 tools/torch_time_upload.py

For arrays of the sizes the streaming engine uploads (a dense forward and a
dense transposed panel of matrix (i) of ``chip_smoke.py`` phase 27, and the
compact COO arrays of a sparse panel of matrix (ii) of phase 28, whose
length differs from panel to panel: each copy here has a size of its own)
it times, over a run of copies of each:

  * ``pageable``: ``torch.from_numpy(a).to("cuda")``, which blocks the host;
  * ``pin_memory``: ``io/upload.py::upload``, the streaming engine's route:
    ``torch.from_numpy(a).pin_memory().to("cuda", non_blocking=True)``, a
    fresh pinned copy of every array.

Each route first copies every array once (allocations), then the run is
timed.  It prints the host seconds per copy (what the engine's
``res.misc["stream"]["upload_s"]`` adds), the seconds until the card has
the data (after a synchronize), the rate in GB/s for both, and the card's
name and power limit.  Needs a CUDA card; imports no JAX.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

COPIES = 20
# (label, shape, dtype, whether each copy has a length of its own): the
# engine's arrays
ARRAYS = (("dense forward panel of (i), 5,000 x 512 float32", (5000, 512),
           np.float32, False),
          ("dense transposed panel of (i), 40,000 x 512 float32",
           (40000, 512), np.float32, False),
          ("COO rows of a (ii) panel, about 4.1M uint16 (as int16)",
           (4_100_000,), np.int16, True),
          ("COO values of a (ii) panel, about 4.1M uint8", (4_100_000,),
           np.uint8, True))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_time_upload: needs a CUDA card")
    from rcppml_tpu_torch.io.upload import upload
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    rs = np.random.RandomState(0)
    dev = torch.device("cuda")
    routes = {
        "pageable": lambda a: torch.from_numpy(a).to(dev),
        "pin_memory": lambda a: upload(a, dev),
    }
    for label, shape, dtype, varying in ARRAYS:
        arrays = [(rs.rand(*(shape if not varying else
                             (shape[0] - 1237 * i,))) * 200).astype(dtype)
                  for i in range(COPIES)]
        nbytes = sum(a.nbytes for a in arrays) / COPIES
        for name, put in routes.items():
            # warm-up over every array: the engine repeats the same sizes
            # every sweep, so the caching host allocator's pinned blocks are
            # allocated once
            for a in arrays:
                put(a)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = [put(a) for a in arrays]
            host_s = (time.perf_counter() - t0) / COPIES
            torch.cuda.synchronize()
            done_s = (time.perf_counter() - t0) / COPIES
            same = all(np.array_equal(outs[i].cpu().numpy(), arrays[i])
                       for i in (0, COPIES - 1))
            if not same:
                raise SystemExit(f"{name}: the copy differs from the source")
            del outs
            print(f"{label} ({nbytes / 2**20:.1f} MiB), {name}: host "
                  f"{host_s * 1e3:.3f} ms a copy ({nbytes / host_s / 1e9:.2f} "
                  f"GB/s), on the card after {done_s * 1e3:.3f} ms "
                  f"({nbytes / done_s / 1e9:.2f} GB/s)  [{card}]", flush=True)


if __name__ == "__main__":
    main()
