"""Beta schedules, respacing and the ancestral sampling loop."""
