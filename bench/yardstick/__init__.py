"""The benchmark's yardstick: what a later change to the program cannot move.

Traffic generation (``traffic``), the device's published peaks and the
operation and byte counts (``counts``), the param maker (``weights``), the
serving loop and its clocks (``loop``), the reduction of a profiler trace
to intervals (``trace``) and the comparison that decides ``correct``
(``check``).  Only ``program`` imports the system under test.
"""
