// bbbpchem.cpp — native featurization fast path for bbbp.
//
// C++ re-implementation of bbbp/chem (SMILES parser, ring/aromaticity
// perception, implicit-H assignment, Morgan/ECFP + path fingerprints) with a
// pthread-parallel batch API. Bit-exact with the Python reference
// implementation: same splitmix-style hash chain, same invariants, same
// dedup rules (verified by tests/test_bitops_zinc.py). This is the host-side
// engine that feeds the screening pipeline (SURVEY.md §7 hard part #1:
// featurization throughput bounds end-to-end screening).
//
// Build: python -m bbbp.native.build  (g++ -O3 -march=native -shared -fPIC)
//
// Exposed C ABI:
//   int bbbp_fingerprints(const char** smiles, int n, int kind, int n_bits,
//                         int radius, float* out, int32_t* bad, int threads);
//     kind: 0 = morgan, 1 = maccs (structural keys, maccs_fingerprint below),
//           2 = path
//     out: row-major [n, dim], dim = n_bits
//     bad[i] = 1 if SMILES i failed to parse (row left zero)

#include <cstdint>
#include <cstring>
#include <functional>
#include <cmath>
#include <algorithm>
#include <map>
#include <set>
#include <string>
#include <thread>
#include <vector>
#include <atomic>

namespace {

// ---------------------------------------------------------------------------
// hashing (must match bbbp/chem/fingerprints.py::_mix)
// ---------------------------------------------------------------------------
static inline uint64_t mix(uint64_t h, uint64_t v) {
  h = (h ^ v) * 0x100000001B3ULL;
  h ^= h >> 29;
  h = h * 0xBF58476D1CE4E5B9ULL;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// molecular graph
// ---------------------------------------------------------------------------
constexpr int BOND_SINGLE = 1, BOND_DOUBLE = 2, BOND_TRIPLE = 3,
              BOND_QUAD = 4, BOND_AROMATIC = 12;

struct Atom {
  int z = 0;
  bool aromatic = false;
  int charge = 0;
  int isotope = 0;
  int n_h = -1;          // -1 = infer
  bool explicit_h = false;
  int chirality = 0;
  bool in_ring = false;
};

struct Bond {
  int a1, a2;
  int order = BOND_SINGLE;
  int stereo = 0;
  bool in_ring = false;
  int other(int i) const { return i == a1 ? a2 : a1; }
  double order_value() const {
    switch (order) {
      case BOND_SINGLE: return 1.0;
      case BOND_DOUBLE: return 2.0;
      case BOND_TRIPLE: return 3.0;
      case BOND_QUAD: return 4.0;
      default: return 1.5;  // aromatic
    }
  }
};

struct Mol {
  std::vector<Atom> atoms;
  std::vector<Bond> bonds;
  std::vector<std::vector<int>> nbr;   // atom -> bond indices
  std::vector<std::vector<int>> rings;

  // reuse support: clear contents but keep allocated capacity (incl. the
  // nbr inner vectors) so batch loops avoid ~n_atoms heap allocs per molecule
  void reset() {
    for (size_t i = 0; i < atoms.size() && i < nbr.size(); i++) nbr[i].clear();
    atoms.clear();
    bonds.clear();
    rings.clear();
  }
  int add_atom(const Atom& a) {
    atoms.push_back(a);
    if (nbr.size() < atoms.size()) nbr.emplace_back();  // else: reset() slot
    return (int)atoms.size() - 1;
  }
  bool add_bond(int a1, int a2, int order, int stereo) {
    if (a1 == a2) return false;
    for (int bi : nbr[a1])
      if (bonds[bi].other(a1) == a2) return false;  // duplicate
    Bond b;
    b.a1 = a1; b.a2 = a2; b.order = order; b.stereo = stereo;
    bonds.push_back(b);
    int idx = (int)bonds.size() - 1;
    nbr[a1].push_back(idx);
    nbr[a2].push_back(idx);
    return true;
  }
  Bond* get_bond(int a1, int a2) {
    for (int bi : nbr[a1])
      if (bonds[bi].other(a1) == a2) return &bonds[bi];
    return nullptr;
  }
  int total_h(int i) const {
    int nh = std::max(atoms[i].n_h, 0);
    for (int bi : nbr[i])
      if (atoms[bonds[bi].other(i)].z == 1) nh++;
    return nh;
  }
};

// element symbol table (subset mirroring mol.py SYMBOL_TO_Z)
static int symbol_z(const std::string& s) {
  static const std::map<std::string, int> tbl = {
      {"H",1},{"He",2},{"Li",3},{"Be",4},{"B",5},{"C",6},{"N",7},{"O",8},
      {"F",9},{"Ne",10},{"Na",11},{"Mg",12},{"Al",13},{"Si",14},{"P",15},
      {"S",16},{"Cl",17},{"Ar",18},{"K",19},{"Ca",20},{"Sc",21},{"Ti",22},
      {"V",23},{"Cr",24},{"Mn",25},{"Fe",26},{"Co",27},{"Ni",28},{"Cu",29},
      {"Zn",30},{"Ga",31},{"Ge",32},{"As",33},{"Se",34},{"Br",35},{"Kr",36},
      {"Rb",37},{"Sr",38},{"Y",39},{"Zr",40},{"Nb",41},{"Mo",42},{"Tc",43},
      {"Ru",44},{"Rh",45},{"Pd",46},{"Ag",47},{"Cd",48},{"In",49},{"Sn",50},
      {"Sb",51},{"Te",52},{"I",53},{"Xe",54},{"Cs",55},{"Ba",56},{"La",57},
      {"Gd",64},{"Pt",78},{"Au",79},{"Hg",80},{"Tl",81},{"Pb",82},{"Bi",83},
      {"Ra",88},{"*",0}};
  auto it = tbl.find(s);
  return it == tbl.end() ? -1 : it->second;
}

// ---------------------------------------------------------------------------
// ring perception (mirrors mol.py::_perceive_rings)
// ---------------------------------------------------------------------------
static bool shortest_path_excl(const Mol& m, int src, int dst, int skip_bond,
                               const std::vector<char>& bridges,
                               std::vector<int>* out, std::vector<int>& prev,
                               std::vector<int>& queue) {
  // Restricting to non-bridge bonds is exact: any simple path src→dst closed
  // by the (src,dst) bond forms a simple cycle, and cycle edges are never
  // bridges — so no path to dst can traverse one, and skipping them leaves
  // the BFS discovery order of reachable-path vertices unchanged.
  int n = (int)m.atoms.size();
  if ((int)prev.size() != n) prev.assign(n, -2);
  queue.clear();
  queue.push_back(src);
  prev[src] = -1;
  size_t qi = 0;
  bool found = false;
  while (qi < queue.size()) {
    int u = queue[qi++];
    if (u == dst) {
      out->clear();
      while (u != -1) { out->push_back(u); u = prev[u]; }
      found = true;
      break;
    }
    for (int bi : m.nbr[u]) {
      if (bi == skip_bond || bridges[bi]) continue;
      int v = m.bonds[bi].other(u);
      if (prev[v] == -2) { prev[v] = u; queue.push_back(v); }
    }
  }
  // reset only the touched entries instead of the whole array
  for (int v : queue) prev[v] = -2;
  return found;
}

// Tarjan bridge finding (iterative); true = bridge (not on any cycle).
// Mirrors mol.py::_find_bridges so ring perception is atom-order invariant.
struct BridgeFrame { int u; int pbond; size_t it; };
struct RingScratch {
  std::vector<int> disc, low, path, key, prev, queue;
  std::vector<char> is_bridge, bond_in_ring;
  std::vector<BridgeFrame> stack;
  std::vector<std::vector<int>> seen;  // sorted ring keys (few per molecule)
};
static thread_local RingScratch RS;

static std::vector<char>& find_bridges(const Mol& m) {
  int n = (int)m.atoms.size();
  std::vector<int>& disc = RS.disc;
  std::vector<int>& low = RS.low;
  disc.assign(n, -1);
  low.assign(n, 0);
  std::vector<char>& is_bridge = RS.is_bridge;
  is_bridge.assign(m.bonds.size(), 0);
  int timer = 0;
  using Frame = BridgeFrame;
  for (int root = 0; root < n; root++) {
    if (disc[root] != -1) continue;
    std::vector<Frame>& stack = RS.stack;
    stack.clear();
    stack.push_back({root, -1, 0});
    disc[root] = low[root] = timer++;
    while (!stack.empty()) {
      Frame& f = stack.back();
      bool advanced = false;
      while (f.it < m.nbr[f.u].size()) {
        int bi = m.nbr[f.u][f.it++];
        if (bi == f.pbond) continue;
        int v = m.bonds[bi].other(f.u);
        if (disc[v] == -1) {
          disc[v] = low[v] = timer++;
          stack.push_back({v, bi, 0});
          advanced = true;
          break;
        } else {
          low[f.u] = std::min(low[f.u], disc[v]);
        }
      }
      if (!advanced && f.it >= m.nbr[f.u].size()) {
        int u = f.u, pbond = f.pbond;
        stack.pop_back();
        if (!stack.empty()) {
          int parent = stack.back().u;
          low[parent] = std::min(low[parent], low[u]);
          if (low[u] > disc[parent]) is_bridge[pbond] = 1;
        }
      }
    }
  }
  return is_bridge;
}

static void perceive_rings(Mol& m) {
  std::vector<char>& bridges = find_bridges(m);
  // dedupe by sorted member list; ring counts per molecule are tiny, so a
  // linear scan over kept keys beats a std::set of vectors (no node allocs)
  std::vector<std::vector<int>>& seen = RS.seen;
  size_t n_seen = 0;
  std::vector<char>& bond_in_ring = RS.bond_in_ring;
  bond_in_ring.assign(m.bonds.size(), 0);
  std::vector<int>& path = RS.path;
  std::vector<int>& key = RS.key;
  std::vector<int>& prev = RS.prev;
  std::vector<int>& queue = RS.queue;
  prev.clear();  // size != n_atoms forces the per-molecule reset in the BFS
  for (size_t bi = 0; bi < m.bonds.size(); bi++) {
    if (bridges[bi]) continue;
    if (!shortest_path_excl(m, m.bonds[bi].a1, m.bonds[bi].a2, (int)bi,
                            bridges, &path, prev, queue))
      continue;
    bond_in_ring[bi] = 1;
    key = path;
    std::sort(key.begin(), key.end());
    bool dup = false;
    for (size_t k = 0; k < n_seen; k++)
      if (seen[k] == key) { dup = true; break; }
    if (!dup) {
      if (seen.size() <= n_seen) seen.emplace_back();
      seen[n_seen++] = key;
      m.rings.push_back(path);
    }
  }
  for (size_t bi = 0; bi < m.bonds.size(); bi++) {
    m.bonds[bi].in_ring = bond_in_ring[bi];
    if (bond_in_ring[bi]) {
      m.atoms[m.bonds[bi].a1].in_ring = true;
      m.atoms[m.bonds[bi].a2].in_ring = true;
    }
  }
}

// ---------------------------------------------------------------------------
// aromaticity perception (mirrors mol.py::_perceive_aromaticity)
// ---------------------------------------------------------------------------
static bool pi_contribution(const Mol& m, int ai,
                            const std::vector<char>& ring_mask, int* out) {
  const Atom& a = m.atoms[ai];
  bool in_ring_double = false, exo_double = false, has_triple = false;
  for (int bi : m.nbr[ai]) {
    const Bond& b = m.bonds[bi];
    int other = b.other(ai);
    if (b.order == BOND_DOUBLE) {
      if (ring_mask[other]) in_ring_double = true;
      else exo_double = true;
    } else if (b.order == BOND_AROMATIC) {
      // canonical rule (mirrors mol.py): delocalized elsewhere → exo
      exo_double = true;
    } else if (b.order == BOND_TRIPLE) {
      has_triple = true;
    }
  }
  if (has_triple) return false;
  if (in_ring_double) { *out = 1; return true; }
  if (exo_double) { *out = 0; return true; }
  int z = a.z;
  if (z == 6) {
    if (a.charge == -1) { *out = 2; return true; }
    if (a.charge == 1) { *out = 0; return true; }
    return false;
  }
  if (z == 7 || z == 15) { *out = 2; return true; }
  if (z == 8 || z == 16 || z == 34) { *out = 2; return true; }
  return false;
}

static bool ring_pi_total(const Mol& m, const std::vector<int>& members,
                          const std::vector<char>& mask, int* total) {
  *total = 0;
  for (int i : members) {
    int c;
    if (!pi_contribution(m, i, mask, &c)) return false;
    *total += c;
  }
  return true;
}

// connected components of pi-capable size-3..7 rings sharing a bond → unions
// (mirrors mol.py::_fused_ring_unions); `small` is the precomputed pi-capable
// ring list, members returned sorted-unique
static std::vector<std::vector<int>> fused_ring_unions(
    const Mol& m, const std::vector<const std::vector<int>*>& small) {
  std::vector<std::vector<int>> out;
  if (small.size() < 2) return out;
  std::vector<std::vector<uint64_t>> bondsets(small.size());
  for (size_t i = 0; i < small.size(); i++) {
    const auto& r = *small[i];
    for (size_t k = 0; k < r.size(); k++) {
      int a1 = r[k], a2 = r[(k + 1) % r.size()];
      bondsets[i].push_back(((uint64_t)std::min(a1, a2) << 32) |
                            (uint32_t)std::max(a1, a2));
    }
    std::sort(bondsets[i].begin(), bondsets[i].end());
  }
  std::vector<int> parent(small.size());
  for (size_t i = 0; i < parent.size(); i++) parent[i] = (int)i;
  std::function<int(int)> find = [&](int i) {
    while (parent[i] != i) { parent[i] = parent[parent[i]]; i = parent[i]; }
    return i;
  };
  for (size_t i = 0; i < small.size(); i++)
    for (size_t j = i + 1; j < small.size(); j++) {
      size_t a = 0, b = 0;
      const auto& bi = bondsets[i];
      const auto& bj = bondsets[j];
      while (a < bi.size() && b < bj.size()) {
        if (bi[a] == bj[b]) { parent[find((int)i)] = find((int)j); break; }
        if (bi[a] < bj[b]) a++; else b++;
      }
    }
  std::map<int, std::set<int>> comps;
  std::map<int, int> counts;
  for (size_t i = 0; i < small.size(); i++) {
    int root = find((int)i);
    comps[root].insert(small[i]->begin(), small[i]->end());
    counts[root]++;
  }
  for (auto& kv : comps)
    if (counts[kv.first] > 1)
      out.emplace_back(kv.second.begin(), kv.second.end());
  return out;
}

static void perceive_aromaticity(Mol& m) {
  // pi contributions depend only on bond orders and charges, which do not
  // change until the bond rewrite below — so per-ring totals and the fused
  // unions are loop-invariant and computed once (the passes only propagate
  // monotone aromatic flags)
  int n = (int)m.atoms.size();
  std::vector<char> mask(n, 0);
  struct Cand { const std::vector<int>* members; std::vector<int> owned; int total; };
  std::vector<Cand> cands;
  std::vector<const std::vector<int>*> small;
  for (auto& ring : m.rings) {
    if (ring.size() < 3 || ring.size() > 7) continue;
    for (int i : ring) mask[i] = 1;
    int total = 0;
    bool ok = ring_pi_total(m, ring, mask, &total);
    for (int i : ring) mask[i] = 0;
    if (!ok) continue;
    small.push_back(&ring);
    cands.push_back({&ring, {}, total});
  }
  for (auto& uni : fused_ring_unions(m, small)) {
    for (int i : uni) mask[i] = 1;
    int total = 0;
    bool ok = ring_pi_total(m, uni, mask, &total);
    for (int i : uni) mask[i] = 0;
    if (!ok) continue;
    cands.push_back({nullptr, std::move(uni), total});
  }
  bool changed = true;
  int passes = 0;
  while (changed && passes < 6) {
    changed = false;
    passes++;
    for (auto& c : cands) {
      if (c.total % 4 != 2) continue;
      const std::vector<int>& mem = c.members ? *c.members : c.owned;
      for (int i : mem)
        if (!m.atoms[i].aromatic) { m.atoms[i].aromatic = true; changed = true; }
    }
  }
  for (auto& ring : m.rings) {
    bool all_arom = true;
    for (int i : ring) if (!m.atoms[i].aromatic) { all_arom = false; break; }
    if (!all_arom) continue;
    for (size_t i = 0; i < ring.size(); i++) {
      Bond* b = m.get_bond(ring[i], ring[(i + 1) % ring.size()]);
      if (b) b->order = BOND_AROMATIC;
    }
  }
}

// ---------------------------------------------------------------------------
// implicit H (mirrors mol.py::_assign_implicit_h)
// ---------------------------------------------------------------------------
static void assign_implicit_h(Mol& m) {
  for (size_t i = 0; i < m.atoms.size(); i++) {
    Atom& a = m.atoms[i];
    if (a.explicit_h || a.n_h >= 0) continue;
    static const std::map<int, std::vector<int>> valences = {
        {5,{3}},{6,{4}},{7,{3,5}},{8,{2}},{15,{3,5}},{16,{2,4,6}},
        {9,{1}},{17,{1}},{35,{1}},{53,{1}}};
    auto it = valences.find(a.z);
    if (it == valences.end()) { a.n_h = 0; continue; }
    double order_sum = 0;
    for (int bi : m.nbr[i]) order_sum += m.bonds[bi].order_value();
    int used = (int)std::ceil(order_sum - 1e-9);
    int adj = (a.z == 7 || a.z == 15) ? a.charge : -std::abs(a.charge);
    int nh = 0;
    for (int v : it->second) {
      if (v + adj >= used) { nh = v + adj - used; break; }
    }
    a.n_h = std::max(0, nh);
  }
}

// ---------------------------------------------------------------------------
// SMILES parser (mirrors smiles.py)
// ---------------------------------------------------------------------------
static bool is_aromatic_bracket(const std::string& s) {
  static const std::set<std::string> arom = {"b","c","n","o","p","s","se","as","te","si"};
  return arom.count(s) > 0;
}

static bool parse_bracket(const std::string& body, Atom* atom) {
  if (body.empty()) return false;
  size_t k = 0, mlen = body.size();
  int isotope = 0;
  while (k < mlen && isdigit((unsigned char)body[k]))
    isotope = isotope * 10 + (body[k++] - '0');
  bool aromatic = false;
  std::string sym;
  if (k + 1 < mlen) {
    std::string two = body.substr(k, 2);
    if (is_aromatic_bracket(two)) {
      sym = two; sym[0] = toupper(sym[0]); aromatic = true; k += 2;
    } else if (isupper((unsigned char)two[0]) && islower((unsigned char)two[1]) &&
               symbol_z(two) >= 0) {
      sym = two; k += 2;
    }
  }
  if (sym.empty()) {
    std::string one = body.substr(k, 1);
    if (is_aromatic_bracket(one)) {
      sym = one; sym[0] = toupper(sym[0]); aromatic = true; k += 1;
    } else if (one == "*" || symbol_z(one) >= 0) {
      sym = one; k += 1;
    } else {
      return false;
    }
  }
  int z = symbol_z(sym);
  if (z < 0) return false;
  atom->z = z;
  atom->aromatic = aromatic;
  atom->isotope = isotope;
  atom->n_h = 0;
  atom->explicit_h = true;
  while (k < mlen) {
    char c = body[k];
    if (c == '@') {
      if (k + 1 < mlen && body[k+1] == '@') { atom->chirality = 2; k += 2; }
      else {
        atom->chirality = 1; k += 1;
        static const char* tags[] = {"TH","AL","SP","TB","OH"};
        for (auto t : tags) {
          if (body.compare(k, 2, t) == 0) {
            k += 2;
            while (k < mlen && isdigit((unsigned char)body[k])) k++;
            break;
          }
        }
      }
    } else if (c == 'H') {
      k++;
      int h = 1;
      if (k < mlen && isdigit((unsigned char)body[k])) {
        h = 0;
        while (k < mlen && isdigit((unsigned char)body[k]))
          h = h * 10 + (body[k++] - '0');
      }
      atom->n_h = h;
    } else if (c == '+' || c == '-') {
      int sign = (c == '+') ? 1 : -1;
      k++;
      int mag;
      if (k < mlen && isdigit((unsigned char)body[k])) {
        mag = 0;
        while (k < mlen && isdigit((unsigned char)body[k]))
          mag = mag * 10 + (body[k++] - '0');
      } else {
        mag = 1;
        while (k < mlen && body[k] == c) { mag++; k++; }
      }
      atom->charge = sign * mag;
    } else if (c == ':') {
      k++;
      while (k < mlen && isdigit((unsigned char)body[k])) k++;
    } else {
      return false;
    }
  }
  return true;
}

static bool parse_smiles(const std::string& s, Mol* mol) {
  if (s.empty()) return false;
  int prev_atom = -1;
  int pending_bond = -1;  // -1 = default
  int pending_stereo = 0;
  std::vector<std::pair<int, std::pair<int,int>>> stack;  // (atom, (bond, stereo))
  // ring-closure table: flat array indexed by digit (0-99), atom<0 = empty —
  // replaces a std::map in the per-molecule hot loop
  struct RingOpen { int atom = -1, bond = -1, stereo = 0; };
  RingOpen ring_open[100];
  int n_ring_open = 0;
  size_t i = 0, n = s.size();
  mol->atoms.reserve(n);
  mol->nbr.reserve(n);
  mol->bonds.reserve(n + 8);

  auto make_bond = [&](int a1, int a2, int code, int stereo) -> bool {
    if (code < 0) {
      code = (mol->atoms[a1].aromatic && mol->atoms[a2].aromatic)
                 ? BOND_AROMATIC : BOND_SINGLE;
    }
    return mol->add_bond(a1, a2, code, stereo);
  };

  while (i < n) {
    char c = s[i];
    if (c == '(') {
      if (prev_atom < 0) return false;
      stack.push_back({prev_atom, {pending_bond, pending_stereo}});
      pending_bond = -1; pending_stereo = 0;
      i++;
    } else if (c == ')') {
      if (stack.empty()) return false;
      prev_atom = stack.back().first;
      stack.pop_back();
      pending_bond = -1; pending_stereo = 0;
      i++;
    } else if (c == '-') { pending_bond = BOND_SINGLE; i++; }
    else if (c == '=') { pending_bond = BOND_DOUBLE; i++; }
    else if (c == '#') { pending_bond = BOND_TRIPLE; i++; }
    else if (c == '$') { pending_bond = BOND_QUAD; i++; }
    else if (c == ':') { pending_bond = BOND_AROMATIC; i++; }
    else if (c == '/') { pending_bond = BOND_SINGLE; pending_stereo = 1; i++; }
    else if (c == '\\') { pending_bond = BOND_SINGLE; pending_stereo = 2; i++; }
    else if (c == '.') { prev_atom = -1; pending_bond = -1; pending_stereo = 0; i++; }
    else if (isdigit((unsigned char)c) || c == '%') {
      if (prev_atom < 0) return false;
      int num;
      if (c == '%') {
        if (i + 2 >= n || !isdigit((unsigned char)s[i+1]) ||
            !isdigit((unsigned char)s[i+2])) return false;
        num = (s[i+1]-'0') * 10 + (s[i+2]-'0');
        i += 3;
      } else {
        num = c - '0';
        i += 1;
      }
      if (ring_open[num].atom >= 0) {
        int open_atom = ring_open[num].atom;
        int open_code = ring_open[num].bond;
        int open_stereo = ring_open[num].stereo;
        ring_open[num].atom = -1;
        n_ring_open--;
        int code = pending_bond >= 0 ? pending_bond : open_code;
        int stereo = pending_stereo ? pending_stereo : open_stereo;
        if (open_atom == prev_atom) return false;
        if (!make_bond(open_atom, prev_atom, code, stereo)) return false;
      } else {
        ring_open[num] = {prev_atom, pending_bond, pending_stereo};
        n_ring_open++;
      }
      pending_bond = -1; pending_stereo = 0;
    } else if (c == '[') {
      size_t j = s.find(']', i);
      if (j == std::string::npos) return false;
      Atom atom;
      if (!parse_bracket(s.substr(i + 1, j - i - 1), &atom)) return false;
      int idx = mol->add_atom(atom);
      if (prev_atom >= 0)
        if (!make_bond(prev_atom, idx, pending_bond, pending_stereo)) return false;
      prev_atom = idx;
      pending_bond = -1; pending_stereo = 0;
      i = j + 1;
    } else {
      // organic subset
      Atom atom;
      // direct z-codes for the organic subset (identical to the symbol_z
      // table; skips a temporary string + map lookup per atom)
      if (i + 1 < n && ((c=='C'&&s[i+1]=='l') || (c=='B'&&s[i+1]=='r'))) {
        atom.z = (c == 'C') ? 17 : 35;
        i += 2;
      } else if (strchr("BCNOPSFI", c)) {
        switch (c) {
          case 'B': atom.z = 5; break;  case 'C': atom.z = 6; break;
          case 'N': atom.z = 7; break;  case 'O': atom.z = 8; break;
          case 'P': atom.z = 15; break; case 'S': atom.z = 16; break;
          case 'F': atom.z = 9; break;  default:  atom.z = 53; break;
        }
        i += 1;
      } else if (strchr("bcnops", c)) {
        switch (c) {
          case 'b': atom.z = 5; break;  case 'c': atom.z = 6; break;
          case 'n': atom.z = 7; break;  case 'o': atom.z = 8; break;
          case 'p': atom.z = 15; break; default:  atom.z = 16; break;
        }
        atom.aromatic = true;
        i += 1;
      } else if (c == '*') {
        atom.z = 0;
        i += 1;
      } else {
        return false;
      }
      int idx = mol->add_atom(atom);
      if (prev_atom >= 0)
        if (!make_bond(prev_atom, idx, pending_bond, pending_stereo)) return false;
      prev_atom = idx;
      pending_bond = -1; pending_stereo = 0;
    }
  }
  if (!stack.empty() || n_ring_open != 0 || mol->atoms.empty()) return false;
  perceive_rings(*mol);
  assign_implicit_h(*mol);    // H from kekulé orders BEFORE aromatization
  perceive_aromaticity(*mol);
  // sanitize: non-ring aromatic bonds (biaryl without '-') demote to single
  for (auto& b : mol->bonds)
    if (b.order == BOND_AROMATIC && !b.in_ring) b.order = BOND_SINGLE;
  return true;
}

// ---------------------------------------------------------------------------
// Morgan fingerprint (mirrors fingerprints.py::morgan_bits)
// ---------------------------------------------------------------------------
static inline int bond_code(int order) {
  switch (order) {
    case BOND_SINGLE: return 1;
    case BOND_DOUBLE: return 2;
    case BOND_TRIPLE: return 3;
    case BOND_AROMATIC: return 4;
    default: return 5;
  }
}

static uint64_t atom_invariant(const Mol& m, int i) {
  const Atom& a = m.atoms[i];
  int heavy_deg = 0;
  for (int bi : m.nbr[i])
    if (m.atoms[m.bonds[bi].other(i)].z > 1) heavy_deg++;
  uint64_t h = 0xcbf29ce484222325ULL;
  h = mix(h, (uint64_t)a.z);
  h = mix(h, (uint64_t)heavy_deg);
  h = mix(h, (uint64_t)m.total_h(i));
  h = mix(h, (uint64_t)(a.charge & 0xFF));
  h = mix(h, a.in_ring ? 1 : 0);
  h = mix(h, a.aromatic ? 1 : 0);
  h = mix(h, (uint64_t)a.isotope);
  return h;
}

// per-thread scratch so repeated morgan_bits calls reuse capacity instead of
// re-allocating ~9 vectors per molecule (the batch APIs call this in a loop)
struct MorganScratch {
  std::vector<uint64_t> inv, new_inv, env, new_env, key_words, key_hash;
  std::vector<std::pair<int, uint64_t>> entries;
  std::vector<std::pair<std::pair<int, uint64_t>, int>> nbrs;
  std::vector<int> order;
};

static void morgan_bits(const Mol& m, int radius, int n_bits,
                        std::vector<uint64_t>* bits) {
  thread_local MorganScratch S;
  int n = (int)m.atoms.size();
  std::vector<uint64_t>& inv = S.inv;
  std::vector<uint64_t>& new_inv = S.new_inv;
  inv.resize(n);
  new_inv.resize(n);
  for (int i = 0; i < n; i++) inv[i] = atom_invariant(m, i);
  for (int i = 0; i < n; i++)
    if (m.atoms[i].z > 1) bits->push_back(inv[i] % n_bits);
  // Bond environments as fixed-stride bitsets over bond indices: union is a
  // word-wise OR and the per-radius carry-over is one memcpy, replacing the
  // per-atom std::set<int> copies that dominated the profile.
  int nw = ((int)m.bonds.size() + 63) / 64;
  if (nw == 0) nw = 1;
  std::vector<uint64_t>& env = S.env;
  std::vector<uint64_t>& new_env = S.new_env;
  env.assign((size_t)n * nw, 0);
  new_env.resize((size_t)n * nw);
  // dedupe entries: (radius, env bitset words) -> min hash, resolved at the
  // end by sorting a flat arena instead of a map keyed by vector<int>
  std::vector<uint64_t>& key_words = S.key_words;  // key bitsets, nw words each
  std::vector<std::pair<int, uint64_t>>& entries = S.entries;  // (radius, inv)
  std::vector<uint64_t>& key_hash = S.key_hash;  // FNV sort accelerator
  key_words.clear();
  entries.clear();
  key_hash.clear();
  auto& nbrs = S.nbrs;  // ((code,inv),bond)
  for (int r = 1; r <= radius; r++) {
    std::memcpy(new_inv.data(), inv.data(), (size_t)n * sizeof(uint64_t));
    std::memcpy(new_env.data(), env.data(), (size_t)n * nw * sizeof(uint64_t));
    for (int i = 0; i < n; i++) {
      if (m.atoms[i].z <= 1) continue;
      nbrs.clear();
      for (int bi : m.nbr[i]) {
        const Bond& b = m.bonds[bi];
        int j = b.other(i);
        if (m.atoms[j].z <= 1) continue;
        nbrs.push_back({{bond_code(b.order), inv[j]}, bi});
      }
      std::sort(nbrs.begin(), nbrs.end(),
                [](auto& x, auto& y) { return x.first < y.first; });
      uint64_t h = 0x9e3779b97f4a7c15ULL;
      h = mix(h, (uint64_t)r);
      h = mix(h, inv[i]);
      uint64_t* ne = &new_env[(size_t)i * nw];
      for (auto& nb : nbrs) {
        h = mix(h, (uint64_t)nb.first.first);
        h = mix(h, nb.first.second);
        int bi = nb.second;
        ne[bi >> 6] |= 1ULL << (bi & 63);
        const uint64_t* ej = &env[(size_t)m.bonds[bi].other(i) * nw];
        for (int w = 0; w < nw; w++) ne[w] |= ej[w];
      }
      new_inv[i] = h;
    }
    inv.swap(new_inv);
    env.swap(new_env);
    for (int i = 0; i < n; i++) {
      if (m.atoms[i].z <= 1) continue;
      const uint64_t* ei = &env[(size_t)i * nw];
      key_words.insert(key_words.end(), ei, ei + nw);
      uint64_t kh = 0xcbf29ce484222325ULL;
      for (int w = 0; w < nw; w++) kh = (kh ^ ei[w]) * 0x100000001B3ULL;
      key_hash.push_back(kh);
      entries.push_back({r, inv[i]});
    }
  }
  int ne = (int)entries.size();
  std::vector<int>& order = S.order;
  order.resize(ne);
  for (int i = 0; i < ne; i++) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int a, int b) {
    if (entries[a].first != entries[b].first)
      return entries[a].first < entries[b].first;
    if (key_hash[a] != key_hash[b]) return key_hash[a] < key_hash[b];
    const uint64_t* wa = &key_words[(size_t)a * nw];
    const uint64_t* wb = &key_words[(size_t)b * nw];
    for (int w = 0; w < nw; w++)
      if (wa[w] != wb[w]) return wa[w] < wb[w];
    return false;
  });
  for (int s = 0; s < ne;) {
    uint64_t best_inv = entries[order[s]].second;
    int e = s + 1;
    while (e < ne && entries[order[e]].first == entries[order[s]].first &&
           std::memcmp(&key_words[(size_t)order[e] * nw],
                       &key_words[(size_t)order[s] * nw],
                       (size_t)nw * sizeof(uint64_t)) == 0) {
      best_inv = std::min(best_inv, entries[order[e]].second);
      e++;
    }
    bits->push_back(best_inv % n_bits);
    s = e;
  }
}

// ---------------------------------------------------------------------------
// path fingerprint (mirrors fingerprints.py::path_bits)
// ---------------------------------------------------------------------------
static inline int path_atom_code(const Mol& m, int i) {
  const Atom& a = m.atoms[i];
  return (a.z << 2) | (a.aromatic ? 2 : 0) | (a.in_ring ? 1 : 0);
}

static uint64_t hash_path_dir(const Mol& m, const std::vector<int>& atoms,
                              const std::vector<int>& bonds, bool rev) {
  uint64_t h = 0x27d4eb2f165667c5ULL;
  int na = (int)atoms.size();
  for (int k = 0; k < na; k++) {
    int ai = rev ? atoms[na - 1 - k] : atoms[k];
    h = mix(h, (uint64_t)path_atom_code(m, ai));
    if (k < (int)bonds.size()) {
      int bi = rev ? bonds[bonds.size() - 1 - k] : bonds[k];
      h = mix(h, (uint64_t)bond_code(m.bonds[bi].order));
    }
  }
  return h;
}

// open-addressing uint64 set (0 = empty slot) for per-path dedup: the DFS
// visits each simple path once per direction, so dedup runs hundreds-to-
// thousands of times per molecule and a node-allocating std::set of vectors
// dominated the path-fp profile
struct U64Set {
  std::vector<uint64_t> slots;
  size_t mask = 0, count = 0;
  void reset(size_t cap_pow2) {
    slots.assign(cap_pow2, 0);
    mask = cap_pow2 - 1;
    count = 0;
  }
  static size_t probe0(uint64_t v, size_t mask) {
    return (size_t)((v * 0x9E3779B97F4A7C15ULL) >> 13) & mask;
  }
  bool insert(uint64_t v) {  // v must be nonzero; true = newly inserted
    if ((count + 1) * 4 >= slots.size() * 3) grow();
    size_t i = probe0(v, mask);
    while (slots[i]) {
      if (slots[i] == v) return false;
      i = (i + 1) & mask;
    }
    slots[i] = v;
    count++;
    return true;
  }
  void grow() {
    std::vector<uint64_t> old;
    old.swap(slots);
    slots.assign(old.size() * 2, 0);
    mask = slots.size() - 1;
    for (uint64_t v : old)
      if (v) {
        size_t i = probe0(v, mask);
        while (slots[i]) i = (i + 1) & mask;
        slots[i] = v;
      }
  }
};

static void path_bits_dfs(const Mol& m, int min_path, int max_path, int n_bits,
                          int bits_per_hash, std::vector<uint64_t>* bits) {
  // dedup key = sorted bond-index list. With max_path <= 7 and < 255 bonds it
  // packs bijectively into one uint64 (byte per bond index + 1, length implied
  // by the nonzero bytes) -> flat-set dedup; larger molecules keep the
  // allocating std::set path for identical semantics.
  bool packed = max_path <= 7 && m.bonds.size() < 255;
  thread_local U64Set seen_fast;
  if (packed) seen_fast.reset(4096);
  std::set<std::vector<int>> seen;
  std::vector<int> path_bonds, path_atoms;

  auto dfs = [&](auto&& self) -> void {
    int L = (int)path_bonds.size();
    if (L >= min_path) {
      bool fresh;
      if (packed) {
        int tmp[8];
        for (int t = 0; t < L; t++) tmp[t] = path_bonds[t];
        std::sort(tmp, tmp + L);
        uint64_t code = 0;
        for (int t = 0; t < L; t++) code = (code << 8) | (uint64_t)(tmp[t] + 1);
        fresh = seen_fast.insert(code);
      } else {
        std::vector<int> key = path_bonds;
        std::sort(key.begin(), key.end());
        fresh = seen.insert(key).second;
      }
      if (fresh) {
        uint64_t fwd = hash_path_dir(m, path_atoms, path_bonds, false);
        uint64_t rv = hash_path_dir(m, path_atoms, path_bonds, true);
        uint64_t h = std::min(fwd, rv);
        uint64_t rng = h;
        for (int t = 0; t < bits_per_hash; t++) {
          rng = mix(rng, 0x2545F4914F6CDD1DULL);
          bits->push_back(rng % n_bits);
        }
      }
    }
    if (L == max_path) return;
    int last = path_atoms.back();
    for (int bi : m.nbr[last]) {
      if (std::find(path_bonds.begin(), path_bonds.end(), bi) != path_bonds.end())
        continue;
      int j = m.bonds[bi].other(last);
      bool in_path = std::find(path_atoms.begin(), path_atoms.end(), j)
                     != path_atoms.end();
      if (in_path && !(j == path_atoms[0] && path_atoms.size() > 2)) continue;
      path_bonds.push_back(bi);
      path_atoms.push_back(j);
      self(self);
      path_bonds.pop_back();
      path_atoms.pop_back();
    }
  };

  for (int start = 0; start < (int)m.atoms.size(); start++) {
    if (m.atoms[start].z <= 1) continue;
    path_atoms.assign(1, start);
    path_bonds.clear();
    dfs(dfs);
  }
}


// ---------------------------------------------------------------------------
// structural keys (mirrors chem/structural_keys.py index-for-index)
// ---------------------------------------------------------------------------
namespace keys {

static int count_z(const Mol& m, std::initializer_list<int> zs) {
  int c = 0;
  for (auto& a : m.atoms)
    for (int z : zs) if (a.z == z) { c++; break; }
  return c;
}

static int count_bond(const Mol& m, int z1, int z2, int order) {
  int lo = std::min(z1, z2), hi = std::max(z1, z2), c = 0;
  for (auto& b : m.bonds) {
    int a = m.atoms[b.a1].z, d = m.atoms[b.a2].z;
    if (std::min(a, d) == lo && std::max(a, d) == hi && b.order == order) c++;
  }
  return c;
}

static int count_motif3(const Mol& m, int zc, int za, int oa, int zb, int ob) {
  int c = 0;
  for (size_t i = 0; i < m.atoms.size(); i++) {
    if (m.atoms[i].z != zc) continue;
    for (int ba : m.nbr[i]) {
      const Bond& b1 = m.bonds[ba];
      if (m.atoms[b1.other((int)i)].z != za || b1.order != oa) continue;
      bool found = false;
      for (int bb : m.nbr[i]) {
        if (bb == ba) continue;
        const Bond& b2 = m.bonds[bb];
        if (m.atoms[b2.other((int)i)].z == zb && b2.order == ob) { found = true; break; }
      }
      if (found) { c++; break; }  // python for/else: break ONLY on success,
                                  // otherwise try the next za-arm
    }
  }
  return c;
}

static int ring_size_count(const Mol& m, int size) {
  int c = 0;
  for (auto& r : m.rings) if ((int)r.size() == size) c++;
  return c;
}

static int aromatic_ring_count(const Mol& m) {
  int c = 0;
  for (auto& r : m.rings) {
    bool all = true;
    for (int i : r) if (!m.atoms[i].aromatic) { all = false; break; }
    if (all) c++;
  }
  return c;
}

static int hetero_ring_count(const Mol& m) {
  int c = 0;
  for (auto& r : m.rings) {
    bool het = false;
    for (int i : r) if (m.atoms[i].z != 6) { het = true; break; }
    if (het) c++;
  }
  return c;
}

static int fused_ring_pairs(const Mol& m) {
  int c = 0;
  for (size_t i = 0; i < m.rings.size(); i++) {
    std::set<int> si(m.rings[i].begin(), m.rings[i].end());
    for (size_t j = i + 1; j < m.rings.size(); j++) {
      int shared = 0;
      for (int a : m.rings[j]) if (si.count(a)) shared++;
      if (shared >= 2) c++;
    }
  }
  return c;
}

static int donor_count(const Mol& m) {
  int c = 0;
  for (size_t i = 0; i < m.atoms.size(); i++)
    if ((m.atoms[i].z == 7 || m.atoms[i].z == 8) && m.total_h((int)i) > 0) c++;
  return c;
}

static int acceptor_count(const Mol& m) {
  int c = 0;
  for (auto& a : m.atoms)
    if ((a.z == 7 || a.z == 8) && a.charge <= 0) c++;
  return c;
}

static int heavy_degree(const Mol& m, int i) {
  int d = 0;
  for (int bi : m.nbr[i]) if (m.atoms[m.bonds[bi].other(i)].z > 1) d++;
  return d;
}

static int rotatable_count(const Mol& m) {
  int c = 0;
  for (auto& b : m.bonds) {
    if (b.order != BOND_SINGLE || b.in_ring) continue;
    if (heavy_degree(m, b.a1) > 1 && heavy_degree(m, b.a2) > 1) c++;
  }
  return c;
}

static int quaternary_c(const Mol& m) {
  int c = 0;
  for (size_t i = 0; i < m.atoms.size(); i++)
    if (m.atoms[i].z == 6 && heavy_degree(m, (int)i) >= 4) c++;
  return c;
}

static int aromatic_z(const Mol& m, int z) {
  int c = 0;
  for (auto& a : m.atoms) if (a.z == z && a.aromatic) c++;
  return c;
}

static int in_ring_z(const Mol& m, int z) {
  int c = 0;
  for (auto& a : m.atoms) if (a.z == z && a.in_ring) c++;
  return c;
}

static int methyl_count(const Mol& m) {
  int c = 0;
  for (size_t i = 0; i < m.atoms.size(); i++)
    if (m.atoms[i].z == 6 && m.total_h((int)i) >= 3) c++;
  return c;
}

static int heavy_atom_count(const Mol& m) {
  int c = 0;
  for (auto& a : m.atoms) if (a.z > 1) c++;
  return c;
}

static int aromatic_all_ring_count(const Mol& m, int size) {
  int c = 0;
  for (auto& r : m.rings) {
    if ((int)r.size() != size) continue;
    bool all = true;
    for (int i : r) if (!m.atoms[i].aromatic) { all = false; break; }
    if (all) c++;
  }
  return c;
}

static void compute(const Mol& m, float* out /* [167] */) {
  for (int i = 0; i < 167; i++) out[i] = 0.0f;
  int k = 1;
  auto put = [&](int v) { out[k++] = v != 0 ? 1.0f : 0.0f; };
  auto ge = [&](int v, int t) { out[k++] = v >= t ? 1.0f : 0.0f; };

  // element presence / thresholds
  for (int z : {3, 5, 14, 15, 16, 34, 33, 52}) put(count_z(m, {z}));
  put(count_z(m, {3,4,11,12,13,19,20,26,27,28,29,30,47,48,50,78,79,80,82,83}));
  struct ZT { int z; std::vector<int> ts; };
  for (auto& zt : std::vector<ZT>{{7,{1,2,3,4}},{8,{1,2,3,4,5}},{16,{2,3}},
                                  {9,{1,2}},{17,{1,2}},{35,{1}},{53,{1}}})
    for (int t : zt.ts) ge(count_z(m, {zt.z}), t);
  int hal = count_z(m, {9,17,35,53});
  put(hal); ge(hal, 2); ge(hal, 3);
  int no = count_z(m, {7,8});
  ge(no, 3); ge(no, 5); ge(no, 7);
  int heavy = heavy_atom_count(m);
  ge(heavy, 10); ge(heavy, 20); ge(heavy, 30); ge(heavy, 40);

  // charges
  int pos = 0, neg = 0, tot = 0;
  for (auto& a : m.atoms) { if (a.charge > 0) pos++; if (a.charge < 0) neg++; tot += a.charge; }
  put(pos); put(neg); put(pos + neg); put(tot != 0 ? 1 : 0);

  // ring topology
  for (int size : {3,4,5,6,7,8}) { int c = ring_size_count(m, size); put(c); ge(c, 2); }
  int nr = (int)m.rings.size();
  put(nr); ge(nr, 2); ge(nr, 3); ge(nr, 4);
  int ar = aromatic_ring_count(m);
  put(ar); ge(ar, 2); ge(ar, 3);
  int hr = hetero_ring_count(m);
  put(hr); ge(hr, 2);
  int fp = fused_ring_pairs(m);
  put(fp); ge(fp, 2);
  int nring = in_ring_z(m, 7);
  put(nring); ge(nring, 2);
  put(in_ring_z(m, 8)); put(in_ring_z(m, 16));
  int an = aromatic_z(m, 7);
  put(an); ge(an, 2);
  put(aromatic_z(m, 8)); put(aromatic_z(m, 16));

  // bonded pairs — one histogram pass over bonds replaces ~41 count_bond
  // scans; key packs (min_z, max_z, order), identical normalization to
  // count_bond so lookups return the same counts
  const int S = BOND_SINGLE, D = BOND_DOUBLE, T = BOND_TRIPLE, A = BOND_AROMATIC;
  auto cb_key = [](int z1, int z2, int order) -> uint32_t {
    int lo = std::min(z1, z2), hi = std::max(z1, z2);
    return ((uint32_t)lo << 16) | ((uint32_t)hi << 8) | (uint32_t)order;
  };
  thread_local std::vector<std::pair<uint32_t, int>> cb_tab;
  cb_tab.clear();
  for (auto& b : m.bonds) {
    uint32_t k = cb_key(m.atoms[b.a1].z, m.atoms[b.a2].z, b.order);
    bool hit = false;
    for (auto& e : cb_tab)
      if (e.first == k) { e.second++; hit = true; break; }
    if (!hit) cb_tab.push_back({k, 1});
  }
  auto cb = [&](int z1, int z2, int order) -> int {
    uint32_t k = cb_key(z1, z2, order);
    for (auto& e : cb_tab)
      if (e.first == k) return e.second;
    return 0;
  };
  int pair_specs[][3] = {
      {6,6,D},{6,6,T},{6,7,S},{6,7,D},{6,7,T},{6,8,S},{6,8,D},{7,7,S},{7,7,D},
      {7,8,S},{7,8,D},{8,8,S},{6,16,S},{6,16,D},{16,8,D},{16,8,S},{16,16,S},
      {6,9,S},{6,17,S},{6,35,S},{6,53,S},{6,15,S},{15,8,D},{15,8,S},{7,16,S},
      {7,15,S},{16,7,D},{6,6,A},{6,7,A},{6,8,A},{6,16,A},{7,7,A}};
  for (auto& ps : pair_specs) put(cb(ps[0], ps[1], ps[2]));
  ge(cb(6, 8, D), 2);
  ge(cb(6, 7, S), 2);
  ge(cb(6, 8, S), 2);
  ge(cb(16, 8, D), 2);
  ge(cb(6, 6, D), 2);
  ge(cb(6, 6, A), 7);
  ge(cb(6, 6, A), 12);
  put(cb(7, 8, D) && count_z(m, {7}));

  // three-atom motifs
  int motif_specs[][5] = {
      {6,7,S,8,D},{6,8,S,8,D},{6,7,S,7,S},{6,8,S,8,S},{6,7,D,7,S},{7,8,D,8,D},
      {16,8,D,8,D},{16,7,S,8,D},{6,6,D,8,S},{6,6,D,7,S},{6,16,S,16,S},
      {7,6,S,6,S},{8,6,S,6,S},{15,8,D,8,S},{6,9,S,9,S},{6,17,S,17,S}};
  for (auto& ms : motif_specs)
    put(count_motif3(m, ms[0], ms[1], ms[2], ms[3], ms[4]));
  // CF3: motif(C,F,F) AND a carbon with >=3 F neighbors
  {
    int cf2 = count_motif3(m, 6, 9, S, 9, S);
    int cf3 = 0;
    for (size_t i = 0; i < m.atoms.size(); i++) {
      if (m.atoms[i].z != 6) continue;
      int nf = 0;
      for (int bi : m.nbr[i]) if (m.atoms[m.bonds[bi].other((int)i)].z == 9) nf++;
      if (nf >= 3) cf3++;
    }
    put(cf2 && cf3);
  }
  ge(count_motif3(m, 6, 7, S, 8, D), 2);
  ge(count_motif3(m, 6, 8, S, 8, D), 2);
  // H patterns
  {
    int oh = 0, sh = 0, nh2 = 0, nh1 = 0, n0 = 0;
    for (size_t i = 0; i < m.atoms.size(); i++) {
      const Atom& a = m.atoms[i];
      int h = m.total_h((int)i);
      if (a.z == 8 && h >= 1 && !a.aromatic) oh++;
      if (a.z == 16 && h >= 1) sh++;
      if (a.z == 7 && h >= 2) nh2++;
      if (a.z == 7 && h == 1) nh1++;
      if (a.z == 7 && h == 0 && !a.aromatic) n0++;
    }
    put(oh); put(sh); put(nh2); put(nh1); put(n0);
  }

  // global thresholds
  int dc = donor_count(m);
  put(dc); ge(dc, 2); ge(dc, 4);
  int ac = acceptor_count(m);
  put(ac); ge(ac, 4); ge(ac, 7);
  int rc = rotatable_count(m);
  put(rc); ge(rc, 3); ge(rc, 6); ge(rc, 9);
  put(quaternary_c(m));
  int mc = methyl_count(m);
  put(mc); ge(mc, 2); ge(mc, 3);
  {
    int triple = 0, iso = 0, chi = 0, stereo = 0, big = 0;
    for (auto& b : m.bonds) { if (b.order == T) triple++; if (b.stereo) stereo = 1; }
    for (auto& a : m.atoms) { if (a.isotope) iso++; if (a.chirality) chi++; }
    for (auto& r : m.rings) if ((int)r.size() >= 9) big++;
    put(triple); put(iso); put(chi); ge(chi, 2); put(stereo); put(big);
  }

  // supplemental
  {
    int carom = aromatic_z(m, 6);
    put(carom); ge(carom, 10);
    int c_acyc_nonarom = 0, c_acyc = 0;
    for (auto& a : m.atoms) {
      if (a.z != 6) continue;
      if (!a.in_ring) { c_acyc++; if (!a.aromatic) c_acyc_nonarom++; }
    }
    put(c_acyc_nonarom); ge(c_acyc, 6);
    int d_exo = 0, d_all = 0;
    for (auto& b : m.bonds) {
      if (b.order == D) { d_all++; if (!b.in_ring) d_exo++; }
    }
    put(d_exo); ge(d_all, 3);
    int phenol = 0, aniline = 0;
    for (size_t i = 0; i < m.atoms.size(); i++) {
      const Atom& a = m.atoms[i];
      bool arom_nbr = false;
      for (int bi : m.nbr[i])
        if (m.atoms[m.bonds[bi].other((int)i)].aromatic) { arom_nbr = true; break; }
      if (a.z == 8 && m.total_h((int)i) >= 1 && arom_nbr) phenol++;
      if (a.z == 7 && arom_nbr && !a.aromatic) aniline++;
    }
    put(phenol); put(aniline);
    put(aromatic_all_ring_count(m, 5));
    put(aromatic_all_ring_count(m, 6));
    int satcarb = 0;
    for (auto& r : m.rings) {
      bool all_c = true, all_arom = true;
      for (int i : r) {
        if (m.atoms[i].z != 6) all_c = false;
        if (!m.atoms[i].aromatic) all_arom = false;
      }
      if (all_c && !all_arom) satcarb++;
    }
    put(satcarb);
  }
}

}  // namespace keys

}  // namespace

extern "C" int bbbp_fingerprints_packed(const char** smiles, int n, int kind,
                                        int n_bits, int radius, uint32_t* out,
                                        int32_t* bad, int threads) {
  // packed variant: out is row-major [n, n_bits/32] uint32 (little bit order)
  if (kind != 0 && kind != 2) return 2;
  if (n_bits % 32 != 0) return 3;
  int words = n_bits / 32;
  if (threads <= 0) threads = (int)std::thread::hardware_concurrency();
  threads = std::max(1, std::min(threads, 64));
  std::atomic<int> next(0);
  auto worker = [&]() {
    std::string s;
    std::vector<uint64_t> bits;
    Mol mol;
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      mol.reset();
      const char* p = smiles[i];
      size_t len = strlen(p);
      while (len > 0 && isspace((unsigned char)p[len - 1])) len--;
      while (len > 0 && isspace((unsigned char)*p)) { p++; len--; }
      s.assign(p, len);
      bool ok = false;
      try { ok = parse_smiles(s, &mol); } catch (...) { ok = false; }
      if (!ok) { bad[i] = 1; continue; }
      bad[i] = 0;
      bits.clear();
      if (kind == 0) morgan_bits(mol, radius, n_bits, &bits);
      else path_bits_dfs(mol, 1, 7, n_bits, 2, &bits);
      uint32_t* row = out + (size_t)i * words;
      for (uint64_t b : bits) row[b >> 5] |= (1u << (b & 31));
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return 0;
}

extern "C" int bbbp_fingerprints(const char** smiles, int n, int kind,
                                 int n_bits, int radius, float* out,
                                 int32_t* bad, int threads) {
  if (kind != 0 && kind != 1 && kind != 2) return 2;
  int dim = (kind == 1) ? 167 : n_bits;
  if (threads <= 0) threads = (int)std::thread::hardware_concurrency();
  threads = std::max(1, std::min(threads, 64));
  std::atomic<int> next(0);

  auto worker = [&]() {
    std::string s;
    std::vector<uint64_t> bits;
    Mol mol;
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      mol.reset();
      const char* p = smiles[i];
      size_t len = strlen(p);
      while (len > 0 && isspace((unsigned char)p[len - 1])) len--;
      while (len > 0 && isspace((unsigned char)*p)) { p++; len--; }
      s.assign(p, len);
      bool ok = false;
      try { ok = parse_smiles(s, &mol); } catch (...) { ok = false; }
      if (!ok) { bad[i] = 1; continue; }
      bad[i] = 0;
      float* row = out + (size_t)i * dim;
      if (kind == 1) {
        keys::compute(mol, row);
        continue;
      }
      bits.clear();
      if (kind == 0) morgan_bits(mol, radius, n_bits, &bits);
      else path_bits_dfs(mol, 1, 7, n_bits, 2, &bits);
      for (uint64_t b : bits) row[b] = 1.0f;
    }
  };

  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return 0;
}
