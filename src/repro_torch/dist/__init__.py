"""Contraction plans and the plan-cached contraction engine."""
