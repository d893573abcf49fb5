"""The roofline's command-line entry (the counterpart of the reference's
``src/repro/launch/roofline_main.py``).  The reference sets XLA's fake
device count before JAX is imported; the fake fleet here is a process group
that ``roofline.main`` starts itself, so this is a plain re-export.

    python -m repro_torch.launch.roofline_main --arch granite-3-8b --cell train_4k --smoke
"""
from repro_torch.launch.roofline import main

if __name__ == "__main__":
    main()
