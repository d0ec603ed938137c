"""Launchers and the LM side's distribution layer (counterpart of
`repro.launch`): logical-axis sharding rules on DTensor (`sharding`),
device meshes (`mesh`), per-cell input and cache specs (`specs`), the
production-mesh dry run (`dryrun`) and the train CLI, one device or a
DxM mesh of ranks (`train`)."""
