"""Systems under test: one file a program entry, benchmark/systems/<name>.py,
named by a traffic mix's `system` and holding a class `System` (the
interface of benchmark/program.py). A mix that drives another entry of the
port adds a file here."""
