"""The reference orchestrator run on the port.

``Raiko`` is ``raiko_tpu.core.orchestrator.Raiko`` with each step
(``generate_input``, ``get_output``, ``prove``) run inside
``seams.bound(device)``, so every device computation of the step goes
through the port.
"""

from __future__ import annotations

from raiko_tpu.core import orchestrator as ref

from .. import device as device_mod
from .. import seams


class Raiko(ref.Raiko):
    def __init__(self, chain_specs, request, device):
        super().__init__(chain_specs, request)
        self.device = device_mod.get(device)

    def generate_input(self):
        with seams.bound(self.device):
            return super().generate_input()

    def get_output(self, guest_input):
        with seams.bound(self.device):
            return super().get_output(guest_input)

    def prove(self, guest_input, output, config=None, ctx=None):
        with seams.bound(self.device):
            return super().prove(guest_input, output, config, ctx)
