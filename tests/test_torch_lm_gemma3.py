"""Port parity of Gemma3-1B (``configs/gemma3_1b.py``) at ``reduced()``
(6 layers: 5 local + 1 global, window 32, d 128, 4 heads over 1 KV head
of 32, qk-norm, the post-block norms, gelu, embed scaling, tied head)
against the jitted JAX engine, in ``dense``, ``int8`` and
``sparse_cfmm`` (tests/_torch_lm_parity.py, bound 0.06).

A 40-token prompt (bucket 64) and ``max_seq`` 64 make the window bind in
prefill (the flash mask) and in decode (``decode_attention``).  The
reduced config's grouping has no suffix, so a 14-layer variant (two
groups of 6 and a 2-layer suffix) runs too.
"""
import dataclasses

import numpy as np
import pytest

from _torch_lm_parity import LMParity, check_run, run_engines
from repro.models import lm as jlm
from repro_torch.models import lm as tlm


class TestGemma3(LMParity):
    ARCH = "gemma3_1b"
    PROMPTS = (40, 13, 11)          # buckets 64, 16, 16
    SLOTS, MAX_SEQ, MAX_NEW = 2, 64, 4

    def test_reduced_window_binds(self):
        jcfg, tcfg = self.configs()
        assert tcfg.window == 32 < max(self.PROMPTS) < self.MAX_SEQ
        assert [s["attn_type"] for s in tcfg.layer_sigs()] == \
            ["local"] * 5 + ["global"]
        assert tlm.group_layers(tcfg.layer_sigs()) == (0, 6, 1, 0)

    def test_full_grouping_has_a_suffix(self):
        """26 layers: 4 groups of the 5:1 period and a 2-layer suffix, as
        JAX groups them (lm.py ``group_layers``)."""
        cfg = self.configs()[1]
        for n, want in ((26, (0, 6, 4, 2)), (14, (0, 6, 2, 2))):
            sigs = dataclasses.replace(cfg, n_layers=n).layer_sigs()
            assert tlm.group_layers(sigs) == jlm.group_layers(sigs) == want

    @pytest.fixture(scope="class")
    def trees14(self):
        """(JAX config, port config, JAX tree, port tree) at 14 layers."""
        jcfg, tcfg = self.configs(n_layers=14)
        return (jcfg, tcfg) + self.init_trees(jcfg)

    def test_fourteen_layers_with_suffix_match_jitted_jax(self, trees14):
        """The stacked template at 2 groups and the unrolled suffix, in
        ``dense``: every call within the bound, the params' suffix leaves
        carried across."""
        jcfg, tcfg, jt, tt = trees14
        assert len(tt["suffix"]) == 2 and len(tt["template"]) == 6
        assert tuple(tt["template"][5]["mixer"]["q"].value.shape)[0] == 2
        run = run_engines(jcfg, tcfg, jt, tt, "dense", self.PROMPTS,
                          self.SLOTS, self.MAX_SEQ, self.MAX_NEW)
        check_run(run, len(self.PROMPTS), self.MAX_NEW, self.BOUND["dense"],
                  "n_layers=14")
        assert np.isfinite(run["calls"][0][3]).all()

    def test_one_slot_with_suffix_matches_jitted_jax(self, trees14):
        """One batch slot: the suffix's unstacked cache leaves, whose dim
        0 is then the one slot, merge as JAX's engine merges them."""
        jcfg, tcfg, jt, tt = trees14
        run = run_engines(jcfg, tcfg, jt, tt, "dense", self.PROMPTS, 1,
                          self.MAX_SEQ, self.MAX_NEW)
        check_run(run, len(self.PROMPTS), self.MAX_NEW, self.BOUND["dense"],
                  "one slot")
