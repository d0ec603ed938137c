"""Launchers (counterpart of `repro.launch`): the single-device train CLI."""
