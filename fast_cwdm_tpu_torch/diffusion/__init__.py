"""Beta schedules, respacing, the sampling loops, the training loss, the
timestep samplers and the likelihood helpers."""
