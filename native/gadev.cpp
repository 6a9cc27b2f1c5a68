// gadev: native runtime engine for genomeassembler_dev.
//
// Hosts the parts of the pipeline that are branchy, string-heavy and
// small-data — a poor fit for the accelerator — behind a C ABI
// consumed via ctypes:
//
//   * the per-ordering greedy contig merge fixpoint
//     (semantics: spec/reference_semantics.py::merge_one_ordering, which in
//     turn documents lib/DeNovoAssembler.cpp:214-305 of the reference),
//     parallelised with std::thread across the ordering ensemble,
//   * ordering generation with std::mt19937 + std::shuffle, bit-identical to
//     the reference's ensemble by construction (same libstdc++),
//   * a single-threaded contig builder + k-mer counter used as the
//     "single-core C++" baseline that bench.py compares the device path against.
//
// This file is new code written from the executable spec; it shares only the
// published algorithm with the reference.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <random>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct ResultSet {
    std::vector<std::string> items;
};

// One ordering's greedy merge to fixpoint. Bit-exact to the spec:
// for k = K-1..1, repeat until count stable: i ascending, j descending,
// merge when str(i) != str(j) and suffix_k(i) == prefix_k(j).
void merge_ordering(std::vector<std::string>& work, int dbg_kmer) {
    for (int k = dbg_kmer - 1; k >= 1; --k) {
        bool shrunk = true;
        while (shrunk) {
            const size_t before = work.size();
            for (size_t i = 0; i < work.size(); ++i) {
                if (work[i].empty()) continue;
                for (size_t jj = work.size(); jj-- > 0;) {
                    const std::string& a = work[i];
                    const std::string& b = work[jj];
                    if (b.empty() || a == b) continue;
                    if (a.size() < static_cast<size_t>(k) ||
                        b.size() < static_cast<size_t>(k))
                        continue;
                    if (std::memcmp(a.data() + a.size() - k, b.data(), k) == 0) {
                        work[i].append(b, k, std::string::npos);
                        work[jj].clear();
                    }
                }
            }
            work.erase(std::remove_if(work.begin(), work.end(),
                                      [](const std::string& s) { return s.empty(); }),
                       work.end());
            shrunk = before != work.size();
        }
    }
}

void canonical_sort(std::vector<std::string>& v) {
    // dedup, then order by length descending with lexicographic ties —
    // the framework's deterministic canonicalisation of the reference's
    // unstable length sort.
    std::sort(v.begin(), v.end());
    v.erase(std::unique(v.begin(), v.end()), v.end());
    std::stable_sort(v.begin(), v.end(),
                     [](const std::string& x, const std::string& y) {
                         return x.size() > y.size();
                     });
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// result-set accessors
// ---------------------------------------------------------------------------

int gadev_result_count(void* h) {
    return static_cast<int>(static_cast<ResultSet*>(h)->items.size());
}

const char* gadev_result_get(void* h, int i, int* len) {
    const std::string& s = static_cast<ResultSet*>(h)->items[i];
    *len = static_cast<int>(s.size());
    return s.data();
}

void gadev_result_free(void* h) { delete static_cast<ResultSet*>(h); }

// ---------------------------------------------------------------------------
// shuffled-ensemble greedy assembly
// ---------------------------------------------------------------------------

// contig_buf: concatenated contig bytes; contig_lens[n_contigs] their lengths.
// Generates `n_orderings` std::shuffle'd orderings of the input list with a
// single mt19937(seed) (state carried across orderings, as the reference
// does), merges each to fixpoint (threaded), dedups and canonically sorts.
void* gadev_assemble(const char* contig_buf, const int* contig_lens,
                     int n_contigs, int dbg_kmer, unsigned seed,
                     int n_orderings, int n_threads) {
    std::vector<std::string> contigs;
    contigs.reserve(n_contigs);
    {
        const char* p = contig_buf;
        for (int i = 0; i < n_contigs; ++i) {
            contigs.emplace_back(p, contig_lens[i]);
            p += contig_lens[i];
        }
    }

    // ordering generation is inherently sequential (shared engine state)
    std::vector<std::vector<int>> orderings(n_orderings);
    {
        std::mt19937 eng(seed);
        std::vector<int> base(n_contigs);
        for (int i = 0; i < n_contigs; ++i) base[i] = i;
        for (int o = 0; o < n_orderings; ++o) {
            orderings[o] = base;
            std::shuffle(orderings[o].begin(), orderings[o].end(), eng);
        }
    }

    if (n_threads < 1) n_threads = 1;
    std::vector<std::vector<std::string>> partial(n_threads);
    std::atomic<int> next{0};
    auto worker = [&](int tid) {
        std::unordered_set<std::string> seen;
        for (;;) {
            int o = next.fetch_add(1);
            if (o >= n_orderings) break;
            std::vector<std::string> work;
            work.reserve(n_contigs);
            for (int idx : orderings[o]) work.push_back(contigs[idx]);
            merge_ordering(work, dbg_kmer);
            for (auto& s : work)
                if (seen.insert(s).second) partial[tid].push_back(std::move(s));
        }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker, t);
    for (auto& th : pool) th.join();

    auto* res = new ResultSet;
    for (auto& part : partial)
        for (auto& s : part) res->items.push_back(std::move(s));
    canonical_sort(res->items);
    return res;
}

// ---------------------------------------------------------------------------
// single-core baseline: contigs from reads (hash-map construction, the shape
// of pipeline the reference uses; bench.py measures this as "1 core C++")
// ---------------------------------------------------------------------------

void* gadev_contigs_from_reads(const char* reads_buf, long n_reads,
                               int read_len, int dbg_kmer) {
    const int k = dbg_kmer;
    // adjacency: prefix -> unique suffixes in insertion order
    std::unordered_map<std::string, std::vector<std::string>> adj;
    for (long r = 0; r < n_reads; ++r) {
        const char* read = reads_buf + r * read_len;
        for (int i = 0; i + k <= read_len; ++i) {
            std::string pre(read + i, k - 1);
            std::string suf(read + i + 1, k - 1);
            auto& lst = adj[pre];
            if (std::find(lst.begin(), lst.end(), suf) == lst.end())
                lst.push_back(std::move(suf));
        }
    }
    std::unordered_map<std::string, std::pair<int, int>> deg;  // in, out
    for (auto& kv : adj) {
        deg[kv.first].second += static_cast<int>(kv.second.size());
        for (auto& s : kv.second) deg[s].first++;
    }
    std::unordered_set<std::string> branch;
    for (auto& kv : deg)
        if ((kv.second.first != 1 || kv.second.second != 1) && adj.count(kv.first))
            branch.insert(kv.first);

    auto* res = new ResultSet;
    std::unordered_set<std::string> out;
    for (const auto& node : branch) {
        for (const auto& e : adj[node]) {
            std::string cur = e;
            std::string path = node;
            while (!branch.count(cur)) {
                auto it = adj.find(cur);
                if (it == adj.end() || it->second.empty()) break;
                path.push_back(cur.back());
                cur = it->second[0];
            }
            path.push_back(cur.back());
            out.insert(std::move(path));
        }
    }
    res->items.assign(out.begin(), out.end());
    std::sort(res->items.begin(), res->items.end());
    return res;
}

// breakage-scoring baseline (single-threaded): for each solution, find the
// first occurrence of every distinct read, expand the break site to the
// 8-mer (2/4/6-mer at the path start, positions 1/2/3), accumulate
// multiplicities, and dot with the combined probability table.
// Semantics: spec/reference_semantics.py::calc_breakscore.
// probs layout: combined table indexed OFFSETS[k] + code (k in 2,4,6,8).
void gadev_breakscore(const char* paths_buf, const int* path_lens, int n_paths,
                      const char* reads_buf, long n_reads, int read_len,
                      const double* probs, double* out_scores,
                      long* out_breaks) {
    static const long kOffsets[5] = {0, 16, 272, 4368, 69904};  // k/2-1 -> off
    int code_of[256];
    for (int i = 0; i < 256; ++i) code_of[i] = 0;
    code_of['A'] = 0; code_of['C'] = 1; code_of['G'] = 2; code_of['T'] = 3;

    std::unordered_map<std::string, long> read_counts;
    for (long r = 0; r < n_reads; ++r)
        read_counts[std::string(reads_buf + r * read_len, read_len)]++;

    const char* p = paths_buf;
    for (int i = 0; i < n_paths; ++i) {
        std::string path(p, path_lens[i]);
        p += path_lens[i];
        double score = 0.0;
        long total = 0;
        for (const auto& kv : read_counts) {
            size_t pos = path.find(kv.first);
            if (pos == std::string::npos) continue;
            long start = pos >= 4 ? static_cast<long>(pos) - 4 : 0;
            int ek = 8;
            if (start == 0) {
                if (pos == 1) ek = 2;
                else if (pos == 2) ek = 4;
                else if (pos == 3) ek = 6;
            }
            long code = 0;
            for (int t = 0; t < ek; ++t)
                code = (code << 2) | code_of[(unsigned char)path[start + t]];
            score += probs[kOffsets[ek / 2 - 1] + code] * kv.second;
            total += kv.second;
        }
        out_scores[i] = score;
        out_breaks[i] = total;
    }
}

// k-mer counting baseline: ACGT byte reads -> counts over 4^k bins.
// Returns number of counted k-mers (invalid bases skipped).
long gadev_count_kmers(const char* reads_buf, long n_reads, int read_len,
                       int k, long* out_counts) {
    const long bins = 1L << (2 * k);
    for (long i = 0; i < bins; ++i) out_counts[i] = 0;
    int code_of[256];
    for (int i = 0; i < 256; ++i) code_of[i] = -1;
    code_of['A'] = 0; code_of['C'] = 1; code_of['G'] = 2; code_of['T'] = 3;
    const long mask = bins - 1;
    long total = 0;
    for (long r = 0; r < n_reads; ++r) {
        const char* read = reads_buf + r * read_len;
        long code = 0;
        int run = 0;  // valid bases in current window
        for (int i = 0; i < read_len; ++i) {
            int c = code_of[static_cast<unsigned char>(read[i])];
            if (c < 0) {
                run = 0;
                code = 0;
                continue;
            }
            code = ((code << 2) | c) & mask;
            if (++run >= k) {
                out_counts[code]++;
                total++;
            }
        }
    }
    return total;
}

}  // extern "C"
