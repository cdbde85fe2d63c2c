"""Binary manifest store (copy of ppasr_tpu/data/binary.py:14-75):
``DatasetWriter`` appends records, each a 4-byte little-endian length and a
UTF-8 JSON line, to ``<prefix>.data`` and their offsets, one per line, to
``<prefix>.header``; ``DatasetReader`` reads them back through a memory
map, keeping the records whose ``duration`` lies in [min_duration,
max_duration] (no upper bound when ``max_duration`` is not positive).
"""
import json
import mmap
import os
import struct


class DatasetWriter:
    def __init__(self, prefix_path: str):
        os.makedirs(os.path.dirname(prefix_path) or '.', exist_ok=True)
        self.data_file = open(prefix_path + '.data', 'wb')
        self.header_file = open(prefix_path + '.header', 'w', encoding='utf-8')
        self.offset = 0
        self.count = 0

    def add_data(self, data: str):
        payload = data.encode('utf-8')
        self.data_file.write(struct.pack('<I', len(payload)))
        self.data_file.write(payload)
        self.header_file.write(f"{self.offset}\n")
        self.offset += 4 + len(payload)
        self.count += 1

    def close(self):
        self.data_file.close()
        self.header_file.close()


class DatasetReader:
    def __init__(self, data_path: str,
                 min_duration: float = 0,
                 max_duration: float = 20):
        self.offsets = []
        with open(data_path + '.header', 'r', encoding='utf-8') as f:
            for line in f:
                if line.strip():
                    self.offsets.append(int(line))
        self.fp = open(data_path + '.data', 'rb')
        self.m = mmap.mmap(self.fp.fileno(), 0, access=mmap.ACCESS_READ)
        # duration filter mirrors reference binary.py:36-70
        if min_duration > 0 or max_duration > 0:
            kept = []
            for off in self.offsets:
                entry = self._read_at(off)
                d = entry.get('duration', 0)
                if d < min_duration:
                    continue
                if 0 < max_duration < d:
                    continue
                kept.append(off)
            self.offsets = kept

    def _read_at(self, offset: int) -> dict:
        (length,) = struct.unpack('<I', self.m[offset:offset + 4])
        payload = self.m[offset + 4:offset + 4 + length]
        return json.loads(payload.decode('utf-8'))

    def get_data(self, idx: int) -> dict:
        return self._read_at(self.offsets[idx])

    def get_keys(self):
        return list(range(len(self.offsets)))

    def __len__(self):
        return len(self.offsets)

    def close(self):
        self.m.close()
        self.fp.close()
