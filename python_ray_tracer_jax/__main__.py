"""``python -m python_ray_tracer_jax`` — the reference's ``main.py`` UX.

Upstream, ``python main.py`` renders the hardcoded 3-sphere demo at
960x540 and prints the wall time (``/root/reference/main.py:53-57``).
Same here, via the CLI (which also accepts flags the reference lacks).
"""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["render", "--builtin", "reference", "-o", "render_out.png"]))
