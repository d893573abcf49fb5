"""repro_torch — the CEFT planning path in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A port of the JAX package ``repro`` (which stays the reference), mirroring its
layout: ``core`` (task graphs, machines, CEFT and the schedulers; the device
sweeps in ``core.ceft_torch``), ``kernels`` (the relaxation kernels, sources in
``csrc/``), ``sched`` (plan cache, straggler loop) and ``graphs`` (workload
generators).  Nothing here imports JAX or the reference package; the
reference's objects come in through :mod:`repro_torch.interop`.
"""
