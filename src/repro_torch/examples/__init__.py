"""The port's counterparts of the JAX package's `examples/*.py`: the
scripts through which users start the system.

    PYTHONPATH=src python -m repro_torch.examples.<name> [options]

quickstart, hpo_service, parallel_hpo, serve, serve_cluster and train_e2e
each take the JAX example's own options and print its lines, plus
`--device` (the card by default; `cpu` runs the plain PyTorch versions;
a card asked for where there is none raises).  `--implementation` has no
counterpart: dispatch goes by device.  Each `main(argv)` returns the
numbers it printed, so tests and `chip_smoke.py` read them without
parsing text.  `nn_objective` is the trainer `parallel_hpo` tunes.
"""
