"""The port's case applications, one module for each reference case
script of ``cases/``.  Each runs as
``python -m rigid_body_2d_3d_pysph_tpu_torch.cases.<name>`` (on the
card; ``--device cpu`` for a CPU run) and writes ``<fname>_output/``
(or ``-d DIR``) in the reference's snapshot layout, so the port's
``validate.py`` and the reference's read it as they are.
"""

import os

# the repository root: the cases read the experiments' data from cases/data
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA_DIR = os.path.join(REPO_ROOT, "cases", "data")
