"""Evaluation harnesses: the BER-vs-SNR sweep (`ber`), the config-5 step
(`step`) and the plots (`plots`, matplotlib imported lazily)."""
