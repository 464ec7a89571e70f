"""Analysis of the port (port of repro.analysis): ``step_cost`` counts one
rank's FLOPs, HBM bytes and collective bytes by running a step on the
"meta" device, where the reference parses compiled HLO
(``repro.analysis.hlo``); ``roofline`` turns them into the three-term
bound on an H100 (``repro.analysis.roofline``, with the TPU's constants
replaced); ``lint`` is the port's static analysis of its own contracts
(``repro.analysis.lint``; ``python -m repro_torch.analysis.lint``).
"""
