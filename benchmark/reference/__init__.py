"""The benchmark's plain reference: torch and numpy only, nothing of the
program under test."""
