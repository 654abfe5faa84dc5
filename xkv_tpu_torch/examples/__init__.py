"""The port's examples (counterparts of ``examples/`` at the repo root):
``quickstart``, ``serving`` and ``accuracy_demo``, each a ``main()`` that
runs on the card unless it is given ``device="cpu"``."""
