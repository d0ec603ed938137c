"""Entry point for a federation shard worker process (counterpart of
`repro/hpo/shard_worker.py`).

    python -m repro_torch.hpo.shard_worker --ckpt-dir <root>/shard-<i> \
        [--spec spec.json] [--host 0.0.0.0] [--port 7341]

Kept separate from `repro_torch.hpo.transport` (which `repro_torch.hpo`
imports at package load) so `-m` never re-executes an already-imported
module.  See `repro_torch.hpo.transport` for the protocol; the worker's
device comes with the spec.
"""
import sys

from repro_torch.hpo.transport import main

if __name__ == "__main__":
    sys.exit(main())
