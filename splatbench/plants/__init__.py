"""Faults as files, one module a fault, found by name
(``splatbench.spec.module("plants", name)``) where ``splatbench/faults.py``
has no ``plant_<name>``: a configuration brings the faults that show its
check fails what it holds the system to. A module has ``plant()``, which
patches the system under test in this process. A benchmark run never
plants one; the tests and ``splatbench.calibrate --fault <name>`` do."""
