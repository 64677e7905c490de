"""Profiling helpers of the port (``profiling``): the ``--trace``
profiler context, the program's spans (``span``), the trainer's epoch
timer and a cProfile decorator."""
