"""Beta schedules, respacing, the sampling loops and their captured CUDA
graph, the training loss, the timestep samplers and the likelihood helpers."""
