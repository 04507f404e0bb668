"""The benchmark's plain reference: torch only, nothing of the program."""
