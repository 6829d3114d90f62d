"""The JAX package's example flows (``examples/`` at the repository's
root), on the port.

One module a flow, each with ``main()`` and a ``python -m`` entry point:

    python -m multirate_tpu_torch.examples.dat_to_cd
    python -m multirate_tpu_torch.examples.wav_resample --demo

They import only ``multirate_tpu_torch`` and run on the card unless given
``device="cpu"``: ``dat_to_cd``, ``naive_vs_polyphase``, ``fir_arbitrary``,
``farrow_exact_delay``, ``interactive_farrow``, ``arb_farrow_speed``,
``wav_resample`` and ``multichannel_time_major``.
"""

FLOWS = ("dat_to_cd", "naive_vs_polyphase", "fir_arbitrary",
         "farrow_exact_delay", "interactive_farrow", "arb_farrow_speed",
         "wav_resample", "multichannel_time_major")
