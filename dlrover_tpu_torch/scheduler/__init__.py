"""Platform layer: declarative job specs and the platform factory.

Counterpart of ``dlrover_tpu/scheduler/``: the job spec
(``job_spec.py``) and ``factory.py`` for the ``process`` and ``local``
platforms. The TPU-VM and GKE platforms have no counterpart this round
(ROADMAP.md): they drive cloud APIs.
"""
