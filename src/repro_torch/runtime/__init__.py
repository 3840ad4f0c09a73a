"""Elastic resume onto another mesh, and GPipe pipeline stages over a
mesh axis."""
from .elastic import resume_on_mesh, world_descriptor  # noqa
from .pipeline import bubble_fraction, pipeline_apply  # noqa
