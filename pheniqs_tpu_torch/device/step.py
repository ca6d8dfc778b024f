"""The decode step: one batch of wire bytes in, the packed decision blob
and the flat counter vector out.

``DecodeStep`` ports ``pheniqs_tpu.device.step.make_decode_step`` in the
configuration the engines run: wire input (``h2d_widths``) in any
quality regime, packed outputs, counters, and (hybrid) the uncertain
mask. Its forward pass is these kernels in order:

  K3 unpack_tokens    wire blob -> every PAMLD and MDD decoder's (N, W) tokens
  K1 pamld_classify   once per PAMLD decoder (K7 past 1024 barcodes, K8
  K6 mdd_classify     on a sharded panel), or MDD decoder, in classify
                      order, chaining qcfail
  K4 counters         (B+1)-bin statistics of the valid rows, flat
  K5 pack_outputs     the (N * total,) uint8 decision blob (d2h_layout)

With ``panel_shards`` it is also the counterpart of
``make_tp_sharded_decode_step`` (step.py:831-925): each PAMLD decoder in
``panel_shards`` classifies through K8 over the shards this process holds,
merging over ``group`` (device/tp.py); on rank 0 everything else runs as
above, on the merged decisions, so the counters come back whole there. A
follower rank runs ``follow``: K3 and its shards' stages only.

On CUDA each is a hand-written kernel; on the CPU each wrapper runs its
plain version. Panel tensors stay on the instrument's device; per batch
the step allocates only its outputs and the stacked per-decoder rows.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels import Decisions
from ..kernels.counters import counters, counters_plain
from ..kernels.mdd import mdd_classify, mdd_classify_plain
from ..kernels.pack import pack_outputs, pack_outputs_plain
from ..kernels.pamld import pamld_classify, pamld_classify_plain, pamld_classify_sharded
from ..kernels.unpack import token_layout, unpack_tokens, unpack_tokens_plain
from .distributed import tp_shape
from .instrument import DeviceInstrument


def check_supported():
    """Refuse what the port has no kernel for yet: reads data parallelism
    inside the PHENIQS_TP mesh (R > 1, ROADMAP item 10; K8's panel
    sharding runs with R = 1)."""
    tp_shape()


class DecodeStep(nn.Module):
    """(blob, ccb, qcb) -> (blob_out (N * total,) uint8, counters (L,) f32)
    for one wire shape: segment ``widths`` and quality regime
    ``qual_bits`` (6, 2, 4 or "j4")."""

    def __init__(
        self,
        instrument: DeviceInstrument,
        widths: list[int],
        qual_bits=6,
        want_uncertain: bool = True,
        panel_shards: dict | None = None,
        group=None,
    ):
        super().__init__()
        check_supported()
        self.instrument = instrument
        self.want_uncertain = want_uncertain
        #: decoder position -> the PanelShards of it this process holds
        self.panel_shards = panel_shards or {}
        #: the PanelGroup the shards merge over (None: every shard here)
        self.group = group
        self.layout = token_layout(instrument, widths, qual_bits)
        self.register_buffer(
            "program",
            torch.from_numpy(self.layout.program).to(instrument.device),
            persistent=False,
        )

    #: the step's stages in order, as ``run_to`` names them
    STAGES = ("unpack", "classify", "counters", "pack")

    def forward(self, blob, ccb=None, qcb=None):
        return self._run(blob, ccb, qcb, plain=False)

    def run_to(self, stage: str, blob, ccb=None, qcb=None):
        """The step's kernels up to and including `stage`, on forward's own
        code path (tools/profile_step.py's rungs): "unpack" returns K3's
        tokens, "classify" the Decisions after every decoder's K1/K6 in
        classify order, "counters" (decisions, flat) after K4, "pack"
        forward's (blob, flat)."""
        if stage not in self.STAGES:
            raise ValueError(f"unknown stage {stage!r}: one of {self.STAGES}")
        return self._run(blob, ccb, qcb, plain=False, stop=stage)

    def forward_plain(self, blob, ccb=None, qcb=None):
        """The same step through every kernel's plain torch version, on
        whatever device ``blob`` is (the reference the kernels are held to)."""
        return self._run(blob, ccb, qcb, plain=True)

    def follow(self, blob, ccb=None, qcb=None):
        """A follower rank's part of the step: K3, then K8's stages on its
        shard of each sharded decoder, taking part in the merges."""
        layout = self.layout
        tokens = unpack_tokens(self.instrument, layout, self.program, blob, ccb, qcb)
        slot = 0
        for k, dec in enumerate(self.instrument.decoders):
            if dec.algorithm not in ("pamld", "mdd") or not dec.plans:
                continue
            if k in self.panel_shards:
                codes, quals, _, _ = tokens.observation(layout, slot)
                pamld_classify_sharded(
                    dec, self.panel_shards[k], codes, quals, None,
                    tpq_constants=self.instrument.tpq_constants, group=self.group, finish=False,
                )
            slot += 1

    def _run(self, blob, ccb, qcb, plain: bool, stop: str = "pack"):
        instrument = self.instrument
        layout = self.layout
        want_uncertain = self.want_uncertain
        if plain:
            tokens = unpack_tokens_plain(instrument, layout, blob, ccb=ccb, qcb=qcb)
        else:
            tokens = unpack_tokens(instrument, layout, self.program, blob, ccb, qcb)
        if stop == "unpack":
            return tokens
        n = blob.shape[0]
        decisions = Decisions.zeros(len(instrument.decoders), n, blob.device)
        qcfail = tokens.qcfail
        slot = 0
        for k, dec in enumerate(instrument.decoders):
            row = decisions.row(k)
            if dec.algorithm in ("pamld", "mdd") and dec.plans:
                codes, quals, lengths, short = tokens.observation(layout, slot)
                slot += 1
                short = short if want_uncertain else None
                if dec.algorithm == "mdd":
                    # integer-exact: never uncertain
                    if plain:
                        result = mdd_classify_plain(dec, codes, quals, lengths, qcfail)
                        for key, value in result.items():
                            row[key].copy_(value)
                    else:
                        mdd_classify(dec, codes, quals, lengths, qcfail, out=row)
                elif k in self.panel_shards:
                    pamld_classify_sharded(
                        dec, self.panel_shards[k], codes, quals, qcfail,
                        tpq_constants=instrument.tpq_constants, want_uncertain=want_uncertain,
                        eps=instrument.tpq_analytic_eps, short=short, out=row, group=self.group,
                        plain=plain,
                    )
                elif plain:
                    result = pamld_classify_plain(
                        dec, codes, quals, qcfail, want_uncertain=want_uncertain,
                        eps=instrument.tpq_analytic_eps, short=short,
                    )
                    for key, value in result.items():
                        row[key].copy_(value)
                else:
                    pamld_classify(
                        dec, codes, quals, qcfail,
                        tpq_constants=instrument.tpq_constants,
                        want_uncertain=want_uncertain,
                        eps=instrument.tpq_analytic_eps,
                        short=short, out=row,
                    )
            else:
                # naive / passthrough: no decision, qcfail passes through
                row["qcfail"].copy_(qcfail)
            qcfail = row["qcfail"]
        if stop == "classify":
            return decisions
        if plain:
            flat = counters_plain(instrument, decisions, tokens.pad, tokens.forced, want_uncertain)
        else:
            flat = counters(instrument, decisions, tokens.pad, tokens.forced, want_uncertain)
        if stop == "counters":
            return decisions, flat
        if plain:
            packed = pack_outputs_plain(instrument, decisions, tokens.forced, want_uncertain)
        else:
            packed = pack_outputs(instrument, decisions, tokens.forced, want_uncertain)
        return packed, flat
