"""Profiling helpers of the port (``profiling``): the ``--trace``
profiler context, the trainer's epoch timer and a cProfile decorator."""
