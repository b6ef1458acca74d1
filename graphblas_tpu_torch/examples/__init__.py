"""Demo programs (counterparts of the JAX package's ``examples/``; the
reference's Demo/Program analogs).  Each module has ``main(device=None,
**sizes)``, which runs the demo at the JAX demo's sizes unless told
otherwise and returns what it prints as a dict, and a ``__main__`` that
prints it:

    python -m graphblas_tpu_torch.examples.bfs_demo [--device cpu]

Without ``--device`` (or ``device=``) the demos run where the ``device``
option points: the card.
"""

import argparse


def cli_device(doc: str):
    """The ``--device`` of a demo's command line (None: the option's)."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device, e.g. cpu or cuda (default: the "
                        "'device' option, cuda)")
    return p.parse_args().device
