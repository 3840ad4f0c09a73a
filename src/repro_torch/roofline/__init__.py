"""Roofline terms of a (model, shape, mesh) cell on the H100: the
first-principles terms (``analytic``), the three-term roofline and the
HLO collective parse (``analysis``), and the counters of one traced step
that stand in for XLA's cost and memory analyses (``count``)."""
