"""repro_torch.examples — the reference's four examples on this package, each
a module with ``run(...)``, which returns the figures it prints, and
``main(argv=None)``; run one with ``python -m repro_torch.examples.<name>``.
Every one but ``quickstart`` (host work only) runs on the card unless
``--device cpu``."""
