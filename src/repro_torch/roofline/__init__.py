"""The dry run's cost counts (``cost``) and their roofline on the card
(``analysis``), the port of ``repro.roofline``.  ``cost`` is imported by
the kernel wrappers, so this package imports nothing at load."""
