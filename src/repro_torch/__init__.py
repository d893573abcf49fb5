"""repro_torch — the CEFT planning path and its serving router in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``repro`` (which stays the reference), mirroring its
layout: ``core`` (task graphs, machines, CEFT and the schedulers; the device
sweeps in ``core.ceft_torch``), ``kernels`` (one CUDA kernel for each Pallas
kernel of the reference, sources in ``csrc/``), ``sched`` (plan cache,
straggler loop, deadline propagation), ``serve`` (admission queue, engine
pool, watchdog, fault injection, router), the models, training and their
launchers, ``substrate`` (meshes, layouts and collectives on
``torch.distributed``, process placement) and ``graphs`` (workload
generators).  Nothing here imports JAX or the
reference package; the reference's objects come in through
:mod:`repro_torch.interop`.
"""
