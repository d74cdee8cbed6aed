"""What every unit of work shares: its arguments and the hooks the window
calls.  A unit is ``units/<name>.py``'s ``Unit``, named by a traffic mix."""

from __future__ import annotations


class UnitBase:
    def __init__(self, seed: int, settings: dict, traffic: dict, run, inject=None, device: str = "cuda"):
        self.seed, self.settings, self.traffic, self.meter = seed, settings, traffic, run
        self.inject, self.device = inject, device
        if inject is not None and inject not in self.faults:
            raise ValueError(f"unit {type(self).__module__}: no fault {inject!r}; it has {sorted(self.faults)}")

    # the faults a test or control.py can plant; the benchmark's runs plant none
    faults: tuple = ()
    # how many units the window's rotation of inputs takes to come round
    cycle: int = 1

    def setup(self) -> None:
        """Build the inputs from the seed and warm every shape the window uses."""

    def describe(self) -> dict:
        """What set-up made, printed on a line of its own before the window."""
        return {}

    def window_start(self) -> None:
        """Read the counters the metrics difference over the window."""

    def window_end(self) -> None:
        pass

    def run(self, i: int) -> None:
        """The window's i-th unit of work."""
        raise NotImplementedError

    def close(self) -> None:
        """Stop what set-up started and free the program's state."""

    def check(self) -> dict:
        """{name: {"value": number, "limit": number}} of the comparison with
        the plain reference: a run is correct when every value is at most
        its limit."""
        return {}
