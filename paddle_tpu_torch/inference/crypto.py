"""Encrypted-model io (a copy of paddle_tpu/inference/crypto.py, the port
of Paddle's framework/io/crypto: CipherFactory, AES in CTR or GCM mode,
CipherUtils' key helpers).

The `cryptography` package provides AES; it is imported when a cipher
is used, not when this module is, so a machine without it imports the
port and runs unencrypted models.  The format on disk is
`nonce || ciphertext [|| tag]`, the reference's framing, so either
package decrypts the other's bytes.
"""

from __future__ import annotations

import os

__all__ = ["Cipher", "AESCipher", "CipherFactory", "CipherUtils"]


class Cipher:
    """Abstract cipher (Paddle's crypto/cipher.h)."""

    def encrypt(self, plaintext: bytes, key: bytes) -> bytes:
        raise NotImplementedError

    def decrypt(self, ciphertext: bytes, key: bytes) -> bytes:
        raise NotImplementedError

    def encrypt_to_file(self, plaintext: bytes, key: bytes, path: str):
        with open(path, "wb") as f:
            f.write(self.encrypt(plaintext, key))

    def decrypt_from_file(self, key: bytes, path: str) -> bytes:
        with open(path, "rb") as f:
            return self.decrypt(f.read(), key)


class AESCipher(Cipher):
    """AES in CTR or GCM mode (Paddle's AES_CTR_NoPadding /
    AES_GCM_NoPadding)."""

    def __init__(self, mode="CTR", iv_size=16, tag_size=16):
        if mode not in ("CTR", "GCM"):
            raise ValueError(f"AESCipher: unsupported mode {mode!r}")
        self._mode = mode
        self._iv_size = iv_size
        self._tag_size = tag_size

    def encrypt(self, plaintext: bytes, key: bytes) -> bytes:
        from cryptography.hazmat.primitives.ciphers import (
            Cipher as _C, algorithms, modes)

        iv = os.urandom(self._iv_size)
        if self._mode == "GCM":
            enc = _C(algorithms.AES(key), modes.GCM(iv)).encryptor()
            ct = enc.update(plaintext) + enc.finalize()
            return iv + ct + enc.tag
        enc = _C(algorithms.AES(key), modes.CTR(iv)).encryptor()
        return iv + enc.update(plaintext) + enc.finalize()

    def decrypt(self, ciphertext: bytes, key: bytes) -> bytes:
        from cryptography.hazmat.primitives.ciphers import (
            Cipher as _C, algorithms, modes)

        iv = ciphertext[:self._iv_size]
        if self._mode == "GCM":
            tag = ciphertext[-self._tag_size:]
            body = ciphertext[self._iv_size:-self._tag_size]
            dec = _C(algorithms.AES(key), modes.GCM(iv, tag)).decryptor()
            return dec.update(body) + dec.finalize()
        dec = _C(algorithms.AES(key), modes.CTR(iv)).decryptor()
        return dec.update(ciphertext[self._iv_size:]) + dec.finalize()


class CipherFactory:
    """Resolves a cipher from a config file's `cipher_name` (default
    AES_CTR_NoPadding), as Paddle's CipherFactory::CreateCipher."""

    @staticmethod
    def create_cipher(config_file=None) -> Cipher:
        name = "AES_CTR_NoPadding"
        if config_file:
            with open(config_file) as f:
                for line in f:
                    if line.strip().startswith("cipher_name"):
                        name = line.split(":")[-1].strip()
        if name.startswith("AES_CTR"):
            return AESCipher("CTR")
        if name.startswith("AES_GCM"):
            return AESCipher("GCM")
        raise ValueError(f"unknown cipher {name!r}")


class CipherUtils:
    """Key helpers (Paddle's cipher_utils.cc)."""

    @staticmethod
    def gen_key(length_bits: int = 256) -> bytes:
        return os.urandom(length_bits // 8)

    @staticmethod
    def gen_key_to_file(length_bits: int, path: str) -> bytes:
        key = CipherUtils.gen_key(length_bits)
        with open(path, "wb") as f:
            f.write(key)
        return key

    @staticmethod
    def read_key_from_file(path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()
