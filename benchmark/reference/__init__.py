"""Plain references of the benchmark's configurations, one module each,
named by a configuration's ``reference`` key. They import nothing of the
program and take nothing it made."""
