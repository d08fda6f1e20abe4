"""Token <-> id mapping.

Capability parity with the reference vocabulary (liteasr/dataclass/vocab.py:
4-85): the vocab file lists ``<token> <id>`` pairs with ids starting at 1;
id 0 is reserved for ``<blank>`` (CTC) and ``<sos/eos>`` is appended as the
final id, so ``len(vocab) == file_lines + 2``. Unknown tokens fall back to
``<unk>``. ``convert`` renders an id for display: specials become the empty
string and ``<space>`` a literal space.
"""

from typing import Any, Iterable, Iterator, Tuple, Union

BLANK = "<blank>"
UNK = "<unk>"
SOS_EOS = "<sos/eos>"
SPACE = "<space>"


def _parse_vocab_file(path: str) -> Iterator[Tuple[str, int]]:
    with open(path, "r") as f:
        for lineno, line in enumerate(f, start=1):
            fields = line.strip().split()
            if len(fields) != 2:
                raise ValueError(
                    f"{path}:{lineno}: expected '<token> <id>', "
                    f"got {line.strip()!r}")
            yield fields[0], int(fields[1])


class Vocab:
    def __init__(self, vocab_path: str) -> None:
        self._id_of = {BLANK: 0}
        self._token_of = [BLANK]
        for token, token_id in _parse_vocab_file(vocab_path):
            if token_id != len(self._token_of):
                raise ValueError(
                    f"{vocab_path}: ids must be dense and start at 1; "
                    f"expected id {len(self._token_of)} but "
                    f"{token!r} has id {token_id}")
            self._id_of[token] = token_id
            self._token_of.append(token)
        self._id_of[SOS_EOS] = len(self._token_of)
        self._token_of.append(SOS_EOS)

    @property
    def valid(self) -> bool:
        return all(self._token_of[i] == t for t, i in self._id_of.items())

    def __getitem__(self, key: Union[str, int]):
        """str -> id (with <unk> fallback); int -> token."""
        if isinstance(key, str):
            return self._id_of.get(key, self._id_of[UNK])
        if isinstance(key, int):
            if key >= len(self._token_of):
                raise IndexError(
                    f"token id {key} out of range "
                    f"(vocab size {len(self._token_of)})")
            return self._token_of[key]
        raise KeyError(f"Vocab is indexed by str or int, not {type(key)}")

    def convert(self, token_id: int) -> str:
        """Render one id for human-readable output."""
        assert isinstance(token_id, int)
        token = self._token_of[token_id]
        if token in (BLANK, SOS_EOS):
            return ""
        if token == SPACE:
            return " "
        return token

    def __len__(self) -> int:
        return len(self._token_of)

    def lookupi(self, seq: Iterable[Any], convert: bool = False):
        if convert:
            return (self.convert(int(t)) for t in seq)
        return (self[t] for t in seq)

    def lookup(self, seq: Iterable[Any], convert: bool = False):
        return tuple(self.lookupi(seq, convert=convert))
