"""The benchmark's own arithmetic: operations and bytes of each step and
kernel, from the configuration's shapes (one module a family), and the
table of the chips' peaks.  Nothing here reads the program."""
