"""``python -m coma_tpu_torch``: list the port's CLIs."""
from __future__ import annotations

import pkgutil

import coma_tpu_torch.cli

PIPELINES = ("generate_2d_hoi_images", "generate_3d_hoi_samples", "learn_coma")


def main() -> None:
    print("coma_tpu_torch: the PyTorch + CUDA port of coma-tpu (NVIDIA H100)")
    print("\nPipelines:")
    for name in PIPELINES:
        print(f"  python -m coma_tpu_torch.cli.{name}")
    print("\nStages:")
    skip = {"_common", *PIPELINES}
    for mod in sorted(m.name for m in pkgutil.iter_modules(coma_tpu_torch.cli.__path__)):
        if mod not in skip:
            print(f"  python -m coma_tpu_torch.cli.{mod}")
    print("\nEach command supports --help and runs on cuda unless given --device cpu. "
          "Docs: README.md")


if __name__ == "__main__":
    main()
