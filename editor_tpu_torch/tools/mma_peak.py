"""The card's mma.sync throughput, the ceiling of the tensor-core bodies of
``editor_tpu_torch/csrc/`` (all on mma.sync m16n8k16).

    python3 -m editor_tpu_torch.tools.mma_peak

Builds ``mma_peak.cu`` (beside this file) with the port's nvcc flags into a
temporary directory and runs it: per line the sums' type (fp32 from bf16, or
f16), the warps an SM, ms and TFLOP/s of 32 independent mma.sync a warp per
round, with no memory traffic. The card's name and power limit come first.
Needs nvcc and a CUDA device; exits non-zero without them.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path


def main() -> None:
    from editor_tpu_torch.ops import _build
    from editor_tpu_torch.tools.profile_forward import card_name

    print(card_name(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        exe = str(Path(tmp) / "mma_peak")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", exe,
                        str(Path(__file__).with_name("mma_peak.cu"))], check=True)
        sys.exit(subprocess.run([exe]).returncode)


if __name__ == "__main__":
    main()
