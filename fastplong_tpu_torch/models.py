"""Host-side read data model — the BEHAVIORAL ORACLE, not the pipeline.

A copy of fastplong_tpu/models.py (JAX-free there too), so that the port
carries the same public per-read API without importing the JAX package.
Library-level equivalent of the reference Read/ReadPair/Sequence classes
(src/read.{h,cpp}, src/sequence.{h,cpp}).  The streaming pipeline operates
on columnar batches and span algebra instead; these objects exist for two
deliberate purposes:
  1. the reference's public per-read API surface for programmatic users
     (exported from the package root), including the vestigial paired-end
     merge;
  2. the documented single-read oracle the property tests compare the
     vectorized span semantics against (break_by_gap / break_by_regions /
     mask_region_with_n mirror read.cpp line-for-line, so a disagreement
     localizes a kernel bug to one read).
Nothing in the hot path imports this module.
"""

from .util import reverse_complement


class Sequence:
    def __init__(self, seq: str):
        self.mStr = seq

    def __len__(self):
        return len(self.mStr)

    def length(self):
        return len(self.mStr)

    def reverse_complement(self):
        return Sequence(reverse_complement(self.mStr))

    def __invert__(self):
        return self.reverse_complement()

    @staticmethod
    def reverse_complement_str(seq: str) -> str:
        return reverse_complement(seq)


class Read:
    def __init__(self, name: str, seq: str, strand: str, quality: str,
                 phred64: bool = False):
        self.name = name
        self.seq = seq
        self.strand = strand
        self.quality = quality
        if phred64:
            self.convert_phred64_to33()

    # ---------------------------------------------------------- accessors

    def length(self):
        return len(self.seq)

    def __len__(self):
        return len(self.seq)

    def to_string(self):
        return "%s\n%s\n%s\n%s\n" % (self.name, self.seq, self.strand,
                                     self.quality)

    def to_string_with_tag(self, tag):
        return "%s %s\n%s\n%s\n%s\n" % (self.name, tag, self.seq,
                                        self.strand, self.quality)

    # ---------------------------------------------------------- mutators

    def convert_phred64_to33(self):
        self.quality = "".join(
            chr(max(33, ord(c) - 31)) for c in self.quality)

    def resize(self, n):
        """Truncate to n bases (no-op if n out of range, read.cpp:62-67)."""
        if n > self.length() or n < 0:
            return
        self.seq = self.seq[:n]
        self.quality = self.quality[:n]

    def trim_front(self, n):
        """Drop the first n bases, clamped to length-1 (read.cpp:69-73);
        negative n empties the read (size_t erase wraparound)."""
        n = min(self.length() - 1, n)
        if n < 0:
            self.seq = ""
            self.quality = ""
            return
        self.seq = self.seq[n:]
        self.quality = self.quality[n:]

    def reverse_complement(self):
        return Read(self.name, reverse_complement(self.seq), "+",
                    self.quality[::-1])

    def low_qual_count(self, qual):
        return sum(1 for c in self.quality if ord(c) < qual + 33)

    def last_index(self):
        name = self.name
        if len(name) < 5:
            return ""
        for i in range(len(name) - 3, -1, -1):
            if name[i] in ":+":
                return name[i + 1:]
        return ""

    def first_index(self):
        name = self.name
        if len(name) < 5:
            return ""
        end = len(name)
        for i in range(len(name) - 3, -1, -1):
            if name[i] == "+":
                end = i - 1
            if name[i] == ":":
                return name[i + 1:end + 1] if end != len(name) else name[i + 1:]
        return ""

    def fix_mgi(self):
        name = self.name
        if name and name[-1] in "12" and len(name) >= 2 and name[-2] == "/":
            self.name = name[:-2] + " " + name[-2:]
            return True
        return False

    def mask_region_with_n(self, start, length):
        if start < 0 or length <= 0 or start >= self.length():
            return
        length = min(length, self.length() - start)
        self.seq = (self.seq[:start] + "N" * length
                    + self.seq[start + length:])

    def break_by_gap(self, start, length):
        """Split around a gap (reference breakByGap, read.cpp:192-215)."""
        out = []
        len1 = start
        len2 = self.length() - start - length
        if len1 > 0:
            out.append(Read(self.name[0] + "split-by-adapter-left-"
                            + self.name[1:],
                            self.seq[:start], self.strand,
                            self.quality[:start]))
        if len2 > 0:
            out.append(Read(self.name[0] + "split-by-adapter-right-"
                            + self.name[1:],
                            self.seq[start + length:], self.strand,
                            self.quality[start + length:]))
        return out

    def break_by_regions(self, regions):
        """Keep fragments between regions (reference breakByRegions,
        read.cpp:227-262)."""
        out = []
        last_end = -1
        for i, (start, end) in enumerate(regions):
            start = max(start, 0)
            end = min(end, self.length() - 1)
            if start > end or start >= self.length():
                continue
            if start > last_end + 1:
                out.append(Read(self.name[0] + ("r%d-" % (i + 1))
                                + self.name[1:],
                                self.seq[last_end + 1:start], self.strand,
                                self.quality[last_end + 1:start]))
            last_end = end
        if last_end < self.length() - 1:
            out.append(Read(self.name[0] + ("r%d-" % (len(regions) + 1))
                            + self.name[1:],
                            self.seq[last_end + 1:], self.strand,
                            self.quality[last_end + 1:]))
        return out


class ReadPair:
    def __init__(self, left: Read, right: Read):
        self.left = left
        self.right = right

    def fast_merge(self):
        """Overlap-merge a pair (reference ReadPair::fastMerge,
        read.cpp:280-352; vestigial in the long-read flow)."""
        rc_right = self.right.reverse_complement()
        len1 = self.left.length()
        len2 = rc_right.length()
        str1, str2 = self.left.seq, rc_right.seq
        qual1, qual2 = self.left.quality, rc_right.quality
        MIN_OVERLAP = 30
        overlapped = False
        olen = MIN_OVERLAP
        diff = 0
        while olen <= min(len1, len2):
            diff = 0
            low_qual_diff = 0
            ok = True
            offset = len1 - olen
            for i in range(olen):
                if str1[offset + i] != str2[i]:
                    diff += 1
                    if ((qual1[offset + i] >= "?" and qual2[i] <= "0")
                            or (qual1[offset + i] <= "0" and qual2[i] >= "?")):
                        low_qual_diff += 1
                    if diff > low_qual_diff or low_qual_diff >= 3:
                        ok = False
                        break
            if ok:
                overlapped = True
                break
            olen += 1
        if not overlapped:
            return None
        offset = len1 - olen
        name = "%s merged offset:%d overlap:%d diff:%d" % (
            self.left.name, offset, olen, diff)
        seq = list(str1[:offset] + str2)
        qual = list(qual1[:offset] + qual2)
        for i in range(olen):
            if str1[offset + i] != str2[i]:
                if qual1[offset + i] >= "?" and qual2[i] <= "0":
                    seq[offset + i] = str1[offset + i]
                    qual[offset + i] = qual1[offset + i]
                else:
                    seq[offset + i] = str2[i]
                    qual[offset + i] = qual2[i]
            else:
                qual[offset + i] = chr(
                    ord(qual1[offset + i]) + ord(qual2[i]) - 33)
        return Read(name, "".join(seq), "+", "".join(qual))
