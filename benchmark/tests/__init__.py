"""The benchmark's own tests, on the CPU at small sizes (cards: `-m cuda`)."""
